#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``automodel_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``ok`` line):

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit;
2. build: every CUDA kernel of the port, from ``csrc/``, one ``nvcc`` per
   source, all started together (set-up);
3. paged-decode kernel: its wrapper against its plain PyTorch version on
   the card, at the serving path's shapes (Llama-3.2-1B: 32/8 heads,
   head_dim 64, plus head_dim 128; block size 16; batch 8; contexts up to
   2048; S = 1, 5 (the speculative verify, bf16 and int8), 32; bf16 and
   int8 pools; soft-cap and window), each
   ``kernel_case`` line with its split plan (span, splits, mode, grid), the
   wrapper call's time (``ms``) and the kernels' own (``device_ms``, the
   host's work hidden behind a spin of the card), for four cases the
   spans 64-1024 timed beside the plan's (``paged_span_sweep``), and the
   decode case at contexts of 16-2048 keys (``paged_ctx_sweep``);
4. attention kernels (forward and backward): each against its plain
   version at the SFT path's shapes (batch 8, S 2048, 32/8 heads, head_dim
   64, the segment ids of a packed batch of the SFT YAML's mock data), plus
   pure causal, head_dim 128, window 256, soft cap 30, S 1000 and the
   MHA head_dim-128 case of the Pallas flash kernel, and the Gemma shapes
   (``gemma*`` rows: the VLM bench YAML's 16 / 8 heads at head_dim 128 with
   window 512 and causal, Gemma-3-4B's 8 / 4 heads at head_dim 256 at B 2
   S 4096 with window 1024 and causal, Gemma-2-2B's with cap 50 and window
   4096); then the flash rung's
   kernels (``flash_case`` lines) at sft_flash's shape (batch 8, S 2048,
   32 heads over kv repeated from 8, head_dim 64, the bench YAML's first
   batch of segment ids, padding rows included, all rows compared), pure
   causal, non-causal and MHA head_dim 128;
   for every kernel case: the kernel's time, the plain version's, one
   PyTorch library call's where one computes the same function, and the
   least time the card could take (bound);
5. engine: Llama-3.2-1B at full width (bf16, weights drawn from a seed)
   through the port's ``DecodeEngine`` with
   ``automodel_tpu_torch/examples/llama3_2_1b_serve.yaml``: the first step's
   logits against the same engine run with the plain attention, then 16
   requests (prompts of 64-1024 tokens, 64 new tokens each) with the
   launch counts zeroed just before and read just after, then a shorter
   int8-KV run the same way, then two profiled windows;
   its quantized-serving and fleet legs on the same model (no new model
   but the serve tool's int8 one): ``serve_fp8`` (float8 tensorwise, the
   first step through every kernel against every plain version within
   the larger of 5 % of the logit range and 3 x the run's floor, 8
   requests of 32 new tokens with qdot once per quantized projection and
   step, beside bf16 on the same requests, a profiled decode window);
   ``serve_int8_base`` (the serve YAML plus ``model.weight_only_quant:
   int8`` through ``tools/serve.py``: every request finished, kernel 1
   once per layer and step, the same prompts through the plain attention
   parting only at near-ties, the projections' bytes against bf16);
   ``serve_fleet`` (the serve tool with ``--replicas 2 --router-policy
   least_loaded --drill-loss-at 20``: exit 0, one loss with its replays,
   one readmission whose weights equal its peer's bit for bit, every
   allocator free, kernel 1 = layers x steps summed over the replicas,
   the rows against one uninterrupted engine; then a loss at the first
   poll, the survivor's rows equal to one engine's); the qdot cases at 8
   decode rows and the 256-row chunk (``serve_fp8_*`` rows);
   before it, the gmm kernel at the multi-tenant LoRA delta's rank-8
   shapes (``lora_gmm_case`` lines: x [m, 2048] x A [17, 2048, 8] and
   h [m, 8] x B [17, 8, 2048], m = 8 and 256) against its plain version,
   with kernel, plain, ``torch._grouped_mm`` and bound times;
   serving_features: the same model through the engine's features at
   ``bench.py``'s leg shapes, each run with the kernel counts zeroed just
   before and read just after (paged decode = layers x steps, gmm = 2 x 7
   adapted projections x layers x steps, no long-query gather) and the
   pool all free after it: prefix caching on and off (16 requests sharing
   a 96-token prefix, bf16 and int8 KV; 8 identical prompts that fork
   copy-on-write), tokens identical; n-gram speculation on and off
   (periodic and all-distinct prompts), tokens identical; multi-tenant
   LoRA with 1, 4 and 16 rank-8 slots, mixed and serial against base
   only, a profiled decode window, and the mixed first step's logits
   against merged single-adapter engines; a seeded Poisson trace, a
   second pass at twice the rate with deadlines, ``max_waiting`` and
   ``by_deadline`` shedding, and an armed ``serve_watchdog_stall``
   recovery whose tokens match an unarmed run;
   serve_moe: Qwen3-30B-A3B at its published widths and 12 of its 48
   layers (``qwen3_30b_a3b_serve.yaml``, the depth cut to
   ``MOE_SERVE_LAYERS`` for the script's time limit; all 48, ~61 GB of
   bf16 weights, served in PRs 15-17) through the same engine phase:
   first the gmm kernel at the engine's routed shapes (a
   decode step's 64 assignments and a prefill chunk's 2048 over 128
   experts, block-padded), the first step through every kernel against
   every plain version, the 16 requests with paged decode held to layers
   x steps and gmm to 3 x layers x steps, profiled windows, then the
   prefix cache on and off (tokens identical); its fp8 leg
   ``serve_moe_fp8`` (qdot 4 x layers and gmm_quant 3 x layers a step,
   the bf16 gmm never) and gmm_quant (e4m3) at the same routed groups;
   serve_qwen2: Qwen2.5-1.5B-Instruct's published config at 14 of 28 layers
   (q / k / v biases, 12 / 2 heads: kernel 1 at G 6), written with random
   bf16 weights as the ``refs/main`` snapshot of its repo id in a
   temporary ``HF_HOME``, loaded by ``AutoModelForCausalLM.
   from_pretrained(..., load_weights=True)`` (every bias and a sample of
   tensors bit for bit as written), then the same engine phase with
   ``qwen2_5_1p5b_serve.yaml``'s serving, and n-gram speculation on and
   off (the verify width) with the same launch gate, tokens identical;
6. linear-CE kernels (forward; backward as dlogits, dh and dW launches
   per chunk of rows): each against its plain version at the bench SFT
   path's shape (T 16384 = 8 x 2048, H 2048, V 128256, the labels of the
   bench YAML's first batch) and at a GPT-2 vocabulary, ragged rows,
   H 4096 and all-ignored labels, with the kernel, plain, library and bound
   times, the forward's product alone (``product_ms``, its epilogue with no
   reduction); beside dlogits, which no one PyTorch call computes, its
   recompute product's ``torch.mm`` per chunk (``product_library_ms``),
   the kernel without its stores (``nostore_ms``) and without its
   epilogue (``product_ms``);
   then the fused quantized matmul (qdot) against its plain version at the
   sft_fp8 path's shapes (m 8 x 2048 tokens; every Llama-3.2-1B projection
   forward, dgrad and wgrad in float8 tensorwise; all four operand pairs
   with both recipes; ragged m; the int8 products of Qwen3-30B-A3B's
   attention): int8 bit-identical, fp8 within a relative L2 limit, with
   kernel (whole call, and its pack and product launches alone), plain,
   library (torch._scaled_mm / torch._int_mm, quantizing excluded), bf16
   torch.matmul and bound times (``qdot_case`` lines); beside them the
   linear-CE kernels at DeepSeek-V2-Lite's head (V 102,400, H 2048, the
   V2-Lite YAML's first batch's labels: ``sft_deepseek_v102400``); then the
   fp8
   product's sums against float64 ones with and without its fp32
   promotion (``qdot_fp8_accumulation``);
7. sft: Llama-3.2-1B at full width and depth trained by the port's recipe
   on ``automodel_tpu_torch/examples/llama3_2_1b_sft.yaml`` (MaskedCE):
   the first step's loss and gradient (2 rows of the first batch) through
   the attention kernels against the plain attention, 2 warm-up steps,
   then the timed steps with the launch counts zeroed just before and read
   just after (step time, tokens/s, MFU, peak memory), then a profiled
   window;
8. sft_bench: the same on ``automodel_tpu_torch/examples/
   llama3_2_1b_bench.yaml`` as written (FusedLinearCrossEntropy through the
   linear-CE kernels, the async input pipeline at depth 2): the first
   step's loss and gradient through the kernels against the fused loss's
   plain route and against MaskedCE on the same weights, then the timed
   steps with the attention and linear-CE launch counts zeroed just before
   and read just after, the producer thread's host seconds, and a profiled
   window; its peak memory must stay below the MaskedCE phase's;
   and one more warmed step's dispatch under
   ``torch.cuda.set_sync_debug_mode("warn")`` counts its synchronizing
   calls (``sft_bench_sync_calls``);
   sft_unpacked: the bench YAML with ``bench.py``'s ``unpacked`` leg
   (no packing, sentences of 1000 +- 30 tokens, ``length_bucket_pool``
   256, rows padded to a multiple of 128: batches [8, 1024 | 1152]): the
   first step also against every kernel's plain version, the attention's
   included, the launch counts for the steps' shapes and the rows' lengths
   per step (``sft_unpacked_shapes``);
   sft_long_16k: ``bench.py``'s ``long_context_16k`` leg (one row of
   16,384 packed tokens a step): the splash kernels at [1, 16384, 32 / 8,
   64] against their plain versions on two kv heads' query heads, the
   launch counts, and MFU without and with the attention FLOPs (causal
   s/2 keys per query within each segment);
   sft_remat_residuals: the bench YAML with ``model.remat_policy:
   save_names:splash_residuals``: the attention forward launches once per
   layer and microbatch (96 over the 6 steps), the backward as in
   sft_bench, the first step equal to the same kernels' under
   ``nothing_saveable``, and the peak memory above sft_bench's
   (``sft_remat_residuals_memory``);
   every phase through the recipe's loop (metrics read one step late,
   input staged on a copy stream), with its ``profile`` line;
   sft_peft: LoRA on ``automodel_tpu_torch/examples/llama3_2_1b_peft.yaml``
   (the bench YAML plus rank-8 adapters on every ``*_proj``; the merge
   path at 1.24 B parameters), sft_qlora_int8: the same with
   ``--peft.quantize_base int8`` (the bypass over an int8 base): the
   first step (adapter gradients) through the kernels against every
   kernel's plain version, the timed steps with attention 2 x layers x
   microbatches forward and layers x microbatches backward, linear-CE 1
   forward and 8 dlogits and dh per microbatch and no dW (the tied head is
   frozen), the base (weights, int8 codes and scales) bit for bit as it
   was, the trainable count the JAX model's (``peft_trainable`` line), an
   adapter save and load bit for bit, and peak memory below sft_bench's;
   sft_flash: the same YAML with the train step's attention on the flash
   rung (``attn_impl="flash"``): the first step against the plain
   attention, then the timed steps with the flash kernels held to 2
   forward and 1 backward launches per layer and microbatch and the
   splash kernels to none;
   ckpt: the same YAML at 4 of its 16 layers (``CKPT_LAYERS``, for the
   script's time limit) with ``--checkpoint.enabled true`` (a temporary
   directory, ``keep_last_k`` 1): inline saves, then asynchronous ones,
   each with its train-loop stall, background commit time and bytes
   (``ckpt_save`` lines), every committed directory verified; then a fresh
   recipe resumes from the last one with weights, optimizer state,
   schedule, RNG, step and loader position bitwise equal to the saved
   ones, and its next step's loss within 1 % of the uninterrupted run's
   (``ckpt_run`` line);
   sft_fp8: the same YAML with ``--fp8.enabled true --fp8.dtype float8``
   (float8 tensorwise quantized compute): every projection through qdot
   (28 launches per layer and microbatch), the first step through every
   kernel against every plain version, and the loss after 8 steps beside
   the bf16 phase's;
9. sft_moe: Qwen3-30B-A3B at its published widths and 4 of its 48 layers
   (``automodel_tpu_torch/examples/qwen3_30b_a3b_sft.yaml``, the bench
   YAML's data, optimizer and fused loss): first the grouped-matmul
   kernels (gmm, its transposed-rhs form for the backward's dlhs, tgmm)
   against their plain versions at the path's shapes -- the group sizes of
   the first batch routed through layer 0 (m 147456 block-padded rows, k, n
   = 2048, 768 and 768, 2048, 128 experts), one expert holding every routed
   row, ragged sizes with empty experts, a skewed routing of many tiny and
   a few hot experts (``skewed_small``), each with rows past the groups --
   with kernel, plain, library (``torch._grouped_mm`` where torch has it)
   and bound times; then the first step through every kernel against every
   plain version, and the timed steps with the gmm / tgmm counts held to
   9 / 3 per layer and microbatch;
10. sft_moe_fp8: the same with ``--fp8.enabled true --fp8.dtype int8``:
   first the quantized grouped matmul (gmm_quant) against its plain version
   at the same four group layouts, int8 and e4m3, and the backward's dlhs
   (``gmm_quant_case`` lines: the whole call, its pack and product launches
   timed apart, and beside the bound the floor of the two passes' bytes),
   then the training with gmm_quant 9, tgmm 3,
   bf16 gmm 0 and qdot 16 launches per layer and microbatch;
11. sft_deepseek: DeepSeek-V2-Lite at its published widths and 4 of 27
   layers (``deepseek_v2_lite_sft.yaml``, the bench YAML's data, optimizer
   and fused loss): the gmm cases at its routed shapes (64 experts of
   1408), the first step through every kernel against every plain version
   (kernel 9 at head_dim 192) and the kernel route twice, bit for bit
   (the routed block's gather adds in a fixed order, as in sft_moe and
   sft_moe_fp8), the timed steps
   with attention 2 x 4 x
   microbatches forward and 4 x backward, gmm 9 and tgmm 3 per routed
   layer and microbatch; generate_deepseek: that model through
   ``generate()`` (8 ragged prompts, 32 new tokens), the prefill on kernel
   9, its logits and the prompts' first tokens against the plain prefill;
   then ``generate_deepseek_fp8``: float8 tensorwise on the experts
   (gmm_quant 3 per routed layer and forward; the MLA projections plain,
   as JAX's), the prefill's logits gated as the bf16 leg's (or 3 x the
   run's floor) and its first tokens equal, a profiled window;
   (the attention phase above also holds kernel 9 at head_dim 192 on the
   V2-Lite YAML's first batch, ``mla_*_d192``, v padded with zeros, and
   the paged-decode phase Qwen3's G 8 decode and verify, ``qwen3_*``);
12. the JAX package's HF fine-tuning YAMLs as written
   (``examples/llm_finetune/qwen3/qwen3_0p6b_hellaswag.yaml``, phase
   sft_qwen3_hellaswag, and ``llama3_2/llama3_2_1b_squad.yaml``, phase
   sft_llama_squad): each model's published config at a quarter of its
   layers (``HF_LAYERS``: 7 of 28, 4 of 16, for the time limit; half
   until the quantized-serving and fleet legs joined) with
   random bf16 weights as an ``HF_HOME`` snapshot under the repo id the
   YAML names, seeded rows in the set's schema as local jsonl, and
   :class:`ByteTokenizer` by ``tokenizer._target_`` (the only overrides,
   with the step count and the checkpoint directory): the loaded weights
   bit for bit as written, kernel 9 at the model's heads on the first
   batch's rows and (Qwen3's V 151,936) kernels 2-4 at its labels against
   their plain versions, the first step against every plain version, the
   exact launch counts over the steps and the validation passes, step
   time, MFU, peak memory, the validation loss and a profiled window;
13. the VLM recipe (``recipes/vlm/finetune.py``, what ``automodel-torch
   finetune vlm`` runs): sft_gemma3_vl_bench, the JAX package's
   ``examples/vlm_finetune/gemma3_vl_bench.yaml`` as written (a 1B-class
   Gemma-3 text tower of 16 layers, 14 with window 512, SigLIP-base, mock
   data, fixed rows of 2048, the fused loss, the embeddings frozen); then
   sft_gemma3_4b_cord, ``gemma3_vl_cord_v2.yaml`` at Gemma-3-4B-it's
   published config at 6 of its 34 text layers (``GEMMA3_4B_LAYERS``,
   for the script's time limit: one of its blocks of 5 sliding layers
   with window 1024 and 1 full; head dim 256, V 262,208, SigLIP-so400m
   at 896 px, all 27 tower layers) written with random bf16
   weights as the ``refs/main`` snapshot of ``google/gemma-3-4b-it`` in
   the temporary ``HF_HOME``, the mock processor at its widths and seeded
   rows in CORD-v2's schema as local jsonl with ``.npy`` images (the
   overrides, with the step count and the checkpoint directory, on the
   phase's line); each: the loaded weights bit for bit, kernel 9 on the
   first batch's rows and kernels 2-4 at its labels against their plain
   versions, the first step against every plain version, the exact launch
   counts (kernel 9 2 x layers x microbatches forward and layers x
   microbatches backward; no linear-CE dW: the tied head is frozen), step
   time, text tokens/s, images/s, MFU from both towers, peak memory and a
   profiled window (``{label}_run`` lines);
14. quant_check: qdot kernel against qdot plain through a 2-layer Llama at
   sft_fp8's widths on the bench YAML's first batch, attention plain on
   both sides, int8 (bit for bit) and float8 (limits set from a measured
   run), loss and whole gradient (``quant_check_* first step`` lines).
15. post-training (run after the VLM phases, before quant_check):
   grpo_llama_1b and dpo_llama_1b, GRPO and DPO on Llama-3.2-1B at its
   published widths (8 of its 16 layers, ``PT_LAYERS``, for the time
   limit) through the recipes' ``setup()`` and
   ``run_post_training_loop()`` on ``automodel_tpu_torch/examples/
   llama3_2_1b_{grpo,dpo}.yaml`` (GRPO with the ``lower_vocab_share``
   reward, named on the phase's line): the first step on one fixed batch
   (GRPO: the first rollout's 64 sequences; DPO: 32 pairs) through every
   kernel against every plain version (loss, pg_loss / kl or margin and
   accuracy, the whole gradient, the logprobs); for GRPO, after the
   warm-up step, the weight handoff (the engine keeps its last sync's
   weights until the next sync, then holds the trainer's bit for bit), a
   temperature-0 rollout of the synced engine token-identical to a fresh
   engine's on the post-step weights and to itself with prefix caching on
   (the group forks' saved prefill printed), and ``generate()`` on the
   post-step weights equal up to near-ties; then 3 timed steps with the
   launch counts of kernels 1-4 and 9 held to the geometry's (kernel 1
   once per layer and decode step, the prefill chunk of 128 on the plain
   gather; kernel 9 3 x layers forward and layers backward per pass of
   the policy with its reference; kernel 2 one per pass, 3-4 one per
   2048 rows of the policy's), step ms, the rollout / logprob / train
   split, rollout tok/s, ``sync_ms``, completion tokens/s, pairs/s, peak
   memory and a profiled step (``{label}_run`` lines); before them the
   paged-decode kernel at GRPO's batch 64 (``grpo_decode_b64_d64_bf16``)
   the linear-CE kernels at T 16,384 / 8,192 with the GRPO / DPO
   cotangents (``grpo_t16384``, ``dpo_t8192``) and kernel 9 at their
   causal rows of 256 (``grpo_rows_64x256_causal``,
   ``dpo_rows_32x256_causal``).
16. pretraining and the remaining text families (after post-training,
   before quant_check): pretrain_gpt2_nanogpt, the JAX package's
   ``examples/llm_pretrain/nanogpt_pretrain.yaml`` as written (GPT-2 124M,
   8 microbatches of 4 rows of 1,024 tokens, collated to 1,152 as in
   JAX) over seeded token shards, overriding only the shards, the step
   count and the checkpoint directory: kernel 9 (12 / 12 heads, D 64) and
   kernels 2-4 (V 50,304) at its shapes, the first step against every
   plain version, exact launches (whole-block remat: kernel 9's forward
   twice a layer and microbatch), and the end-of-run safetensors read
   back bit for bit; sft_seqcls_llama_1b, ``tiny_llama_seqcls_mock
   .yaml``'s sections over Llama-3.2-1B's published config (4 of 16
   layers, ``SEQCLS_LAYERS``, for the time limit, 8 before the fleet legs;
   a fresh
   2-label head) with rows of ~256 tokens at V 128,256: kernel 9 on
   padding-folded segments, no linear-CE launch, the first step against
   plain attention; sft_granite, sft_olmo2, sft_starcoder2 and sft_phi3,
   the bench YAML's sections over each family's published ``config.json``
   (``FAMILY_CONFIGS``) at ``FAMILY_LAYERS`` layers, loaded by
   ``from_pretrained`` from a temporary ``HF_HOME``: ``train_phase``'s
   gates, the weights bit for bit, kernel 9 at the family's heads, scale
   and window (StarCoder-2 in rows of 8,192) and kernels 2-4 at its
   vocabulary (Granite's divisor folded into the head); then kernel 9 at
   Phi-3.5-mini's D 96 (padded to 128) and Granite's scale
   (``FAMILY_ATTN_CASES``).
17. Qwen2.5-VL (after sft_gemma3_4b_cord): kernel 9 non-causal at the
   tower's shapes (16 / 16 heads, head_dim 80 zero-padded to 128): a
   full-attention block over one 56 x 56 frame, a window block's 49
   windows of 64 patches and a 60 x 60 grid's 64 windows with pad slots
   (``qwen_attn_cases``); then sft_qwen25_vl_3b_rdr,
   ``examples/vlm_finetune/qwen2_5_vl_3b_rdr.yaml`` at
   Qwen2.5-VL-3B-Instruct's published widths (``qwen25_vl_3b_config``) at
   4 of its 36 text layers and vision blocks 0-7 of 32
   (``QWEN25_VL_TEXT_LAYERS`` / ``QWEN25_VL_VISION_BLOCKS``, for the
   script's time limit), random bf16 weights as the ``refs/main``
   snapshot of ``Qwen/Qwen2.5-VL-3B-Instruct`` in the temporary
   ``HF_HOME``, the processor section replaced by the mock
   ``Qwen2_5_VLProcessor`` at the published patch geometry, seeded rows
   in RDR's schema; and sft_qwen25_vl_video_mock,
   ``tiny_qwen25_vl_video_mock.yaml`` as written (4 steps); each
   (``qwen_vl_phase``): the loaded weights bit for bit, kernel 9 at the
   decoder's rows of the first batch against its plain version, the first
   step against every plain version, the exact launch counts over the
   timed steps (kernel 9 2 x (text layers + vision blocks) x microbatches
   forward under remat, half that backward; the plain attention 0), step
   time, non-pad tokens/s, images/s, peak memory, the losses per step, a
   profiled window, and the RDR YAML's consolidated checkpoint at one
   more step read back bit for bit (``{label}_run`` lines).
18. Gemma-3n (after the Qwen2.5-VL phases): kernel 9 at Gemma-3n-E4B's
   shapes (B 2, S 4096, 8 / 2 heads at head_dim 256, softmax scale 1.0,
   window 512 and causal full; ``GEMMA3N_ATTN_CASES``); then
   sft_gemma3n_e4b_medpix, ``examples/vlm_finetune/gemma3n_vl_medpix
   .yaml`` at google/gemma-3n-E4B-it's published widths
   (``gemma3n_e4b_config``) at the first 5 of its 35 layers
   (``GEMMA3N_E4B_LAYERS``: one published block of 4 sliding and 1 full,
   all with the sparse gate), random bf16 weights as the ``refs/main``
   snapshot of ``google/gemma-3n-e4b-it`` in the temporary ``HF_HOME``,
   the mock processor at 768 px / 48 (256 placeholders), seeded rows in
   MedPix's schema and ``--checkpoint.save_consolidated true`` (its
   Orbax save is not ported); sft_gemma3n_e4b_medpix_peft, the PEFT YAML
   as written over the same snapshot (LoRA merged on the seven decoder
   projections, ``peft_checks``, the adapter count against the JAX
   formula); and sft_gemma3n_mock, ``tiny_gemma3n_mock.yaml`` as written
   (6 steps; a sparse and two dense gates); each (``gemma3n_phase``): the
   loaded weights bit for bit, kernel 9 at the decoder's rows of the
   first batch against its plain version, the first step against every
   plain version, the exact launch counts (kernel 9 2 x layers x
   microbatches forward under remat, layers x microbatches backward; the
   plain attention 0), step time, non-pad tokens/s, images/s, MFU by the
   work done, peak memory, the losses, a profiled window, and the
   YAML's checkpoint at one more step read back bit for bit
   (``{label}_run`` lines).
19. Phi-4-multimodal (after the Gemma-3n phases): sft_phi4_mm_mock,
   ``examples/vlm_finetune/tiny_phi4_mm_mock.yaml`` as written (6 steps of
   8 one-row microbatches; the tiny decoder's head_dim 16 on kernel 9
   zero-padded); sft_phi4_mm_audio, the same YAML at
   Phi-4-multimodal-instruct's published widths (``phi4_mm_config``: text
   H 3,072, 24 / 8 heads at head_dim 128, partial rotary 0.75, V 200,064,
   window 262,144; the conformer's D 1,024, 16 heads, time reduction 8)
   at 4 of its 32 decoder layers and 6 of its 24 conformer blocks
   (``PHI4_MM_TEXT_LAYERS`` / ``PHI4_MM_AUDIO_BLOCKS``), random bf16
   weights as the ``refs/main`` snapshot of
   ``microsoft/Phi-4-multimodal-instruct`` in the temporary ``HF_HOME``,
   the mock ``Phi4MMProcessor`` at the published widths, seeded audio
   rows (``phi4_audio_rows``: clips of 3-15 s), global batch 8 / local 4
   and a consolidated checkpoint; each (``phi4_mm_phase``): the loaded
   weights bit for bit, kernel 9 at the decoder's rows of the first batch
   (causal, and the raw kernel at the published window, which
   ``attention()`` runs as causal over these rows) against its plain
   version, the first step against
   every plain version, the exact launch counts (kernel 9 2 x layers x
   microbatches forward under remat, layers x microbatches backward; the
   conformer none), step time, non-pad tokens/s, audio seconds/s, MFU by
   the work done (decoder, encoder and projector) beside JAX's decoder
   count, peak memory, the conformer's parts (its plain attention core,
   convolution module and subsampling, forward and backward, device
   times from a ``torch.profiler`` trace, and their share of the
   profiled step's device time and of its wall time), a profiled window, and the checkpoint read back
   bit for bit (``{label}_run`` lines).
20. VLM decode with a cache: generate_gemma3_4b_cord (after
   sft_gemma3_4b_cord) and generate_qwen25_vl_3b_rdr (after
   sft_qwen25_vl_3b_rdr), each over its SFT phase's consolidated export
   through ``from_pretrained`` and ``generate()`` (the exports' depth:
   6 of 34 and 4 of 36 text layers): 4 prompts of one image each (the
   mock processor's ids and pixels), right-padded and left-aligned by
   ``generate()``, 32 new tokens greedy, with the kernel prefill and with
   the plain one (``vlm_generate_phase``): the prefill's last logits
   within 5 % of the logit range and the prompts' first tokens equal;
   kernel 9 launches exactly once per decoder layer on the prefill (plus
   the Qwen2.5-VL tower's 8 blocks) and never on a decode step; kernel 9
   against its plain version at the plans the prefill runs on its rows
   (Gemma-3's window 1,024 spans its 322 rows, so both its layer kinds
   run full causal); prefill ms and decode tokens/s.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
INT8_FP8_OPS_PER_S = 1979e12       # H100 SXM dense fp8 / int8 peak
L2_FLUSH_BYTES = 64 << 20          # > the 50 MB L2: each timed launch is cold
HIDE_HOST_CYCLES = 2_000_000       # ~1 ms of spinning at the H100's clocks

# bf16 output: one ulp at |x| in [2, 4) is 1.6e-2, and the two versions
# round from fp32 sums taken in another order
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# first-step logits, kernel vs plain attention: both round activations to
# bf16 at every projection of 16 layers and the attention outputs differ by
# about one bf16 ulp, which the layers carry; 5 % of the logit range holds
# that, while a wrong kernel moves logits by O(range)
LOGITS_REL_TOL = 5e-2
# attention gradients, kernel vs plain, as relative L2 error over the whole
# tensor: the kernel rounds P and dS to bf16 before its products (the
# plain version keeps fp32) and writes bf16, ~2^-9 relative per element; a
# wrong formula moves them by O(1)
GRAD_REL_L2 = 2e-2
# SFT first step, attention kernels vs the plain attention through the
# bf16 model: the loss within 1 % and the whole gradient (every parameter,
# relative L2) within 10 %.  Both versions round to bf16 at every
# projection of 16 layers and in the backward of each, which amplifies
# small differences: kernel vs plain by ~3.8 % (an H100 run of this
# script, PR 10), and two kernel runs differed by ~1.3 % while the
# attention backward summed dQ with atomics.  A wrong kernel moves both by
# O(1).
SFT_LOSS_REL_TOL = 1e-2
SFT_GRAD_REL_L2 = 1e-1
# The same check under quantized compute (sft_fp8, sft_moe_fp8).  8-bit
# codes are coarse, so a perturbation of a few ulps upstream of a
# quantization flips the codes of the values that sit near a rounding
# midpoint, and each flip moves a product by a whole step; over the layers
# the flips compound.  Two equally right computations then differ by far
# more than 10 %: under float8 on the H100, the kernels against themselves
# (the dQ atomics' order) by 19 % (relative L2 of the whole gradient) and
# against the plain versions by 33 %; on the CPU, a 16-layer tiny Llama
# whose fp8 products sum in fp32 instead of float64 differs by 7 % (16 % at
# layer 0).  So the quantized limit is QUANT_GRAD_FLOOR_FACTOR times this
# run's floor, at least SFT_GRAD_REL_L2 and at most QUANT_GRAD_REL_L2_CAP:
# an unrelated gradient is ~141 % off, a wrong kernel O(1).  The floor is
# two equally right computations of the step: every kernel, against every
# kernel but the attention's plain version (the attention kernels round P
# and dS to bf16; until PR 11 the floor was two kernel runs, which the dQ
# atomics made differ, and the attention backward has none since).  The
# kernels themselves are held exactly (int8) or to 1e-3 (fp8) by their own
# cases.
QUANT_GRAD_FLOOR_FACTOR = 3.0
QUANT_GRAD_REL_L2_CAP = 0.6
SFT_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                        "llama3_2_1b_sft.yaml")
PEFT_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "llama3_2_1b_peft.yaml")
BENCH_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                          "llama3_2_1b_bench.yaml")
SFT_WARMUP, SFT_STEPS, SFT_PROFILED = 2, 6, 2
# linear-CE forward: one bf16 product of K = H against the same product in
# fp32, summed in another order (2e-2 + 2e-2 |ref|, as the other kernels)
LCE_ATOL = LCE_RTOL = 2e-2
# grouped matmuls, relative L2 over the whole output: bf16 operands, fp32
# sums taken in another order, bf16 output (~2^-9 relative per element); a
# wrong group or tile moves it by O(1)
GMM_REL_L2 = 2e-2
MOE_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                        "qwen3_30b_a3b_sft.yaml")
# quantized matmuls (qdot, gmm_quant), fp8 operands: the kernel and the
# plain version multiply the same codes, the kernel summing in the tensor
# cores' fp32 accumulator, the plain version in float64 (measured ~1e-7
# apart); relative L2 over the whole output.  A
# wrong code, scale or tile moves it by O(1e-2) to O(1).  int8 products are
# held bit-identical instead (exact int32 sums, the same fp32 rescale).
QDOT_FP8_REL_L2 = 1e-3
# linear-CE backward, relative L2 of dh and dW over the whole tensor: both
# versions round dlogits to bf16 before the products (the TPU kernel's own
# rounding, automodel_tpu/ops/linear_ce_kernel.py:231, :258) and the
# kernels write bf16 results; a wrong formula moves them by O(1)
LCE_GRAD_REL_L2 = 2e-2


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, iters, flush=None, warmup=3, hide_host=False):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after ``warmup`` calls; ``flush`` (a large buffer) is rewritten before
    each launch so the L2 holds none of its inputs.  With ``hide_host`` the
    card first spins for ~1 ms, so the host has queued all of ``fn``'s
    launches before the start event and the time is the device's alone
    (for calls whose host work outlasts their kernels)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def roofline_ms(ops, nbytes, ops_per_s=BF16_OPS_PER_S):
    """(bound_ms, bound_by): the larger of ``nbytes`` over HBM bandwidth and
    ``ops`` over the tensor-core peak (bf16 unless ``ops_per_s`` says
    otherwise)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
KERNEL_CASES = [
    # (name, S, D, kv dtype, soft_cap, window); the first is the decode
    # step of the engine phase and stands for the kernel in the JSON line
    ("decode_d64_bf16", 1, 64, "bf16", None, None),
    ("decode_d64_int8", 1, 64, "int8", None, None),
    ("verify_s5_d64_bf16", 5, 64, "bf16", None, None),
    ("verify_s5_d64_int8", 5, 64, "int8", None, None),
    ("chunk_s32_d64_bf16", 32, 64, "bf16", None, None),
    ("chunk_s32_d64_int8", 32, 64, "int8", None, None),
    ("decode_d64_bf16_cap_window", 1, 64, "bf16", 30.0, 256),
    ("chunk_s32_d64_bf16_window", 32, 64, "bf16", None, 256),
    ("decode_d128_bf16", 1, 128, "bf16", None, None),
    ("verify_s5_d128_int8_cap", 5, 128, "int8", 30.0, None),
    ("chunk_s32_d128_bf16_window", 32, 128, "bf16", None, 512),
    # Qwen3-30B-A3B through the engine (serve_moe): 32 / 4 heads (G 8) of
    # head_dim 128, the decode step and the speculative verify width
    ("qwen3_decode_d128_g8", 1, 128, "bf16", None, None),
    ("qwen3_verify_s5_d128_g8", 5, 128, "bf16", None, None),
    # Qwen2.5-1.5B through the engine (serve_qwen2): 12 / 2 heads, G 6,
    # the first group count off a power of two
    ("qwen2_decode_d128_g6", 1, 128, "bf16", None, None),
    ("qwen2_verify_s5_d128_g6", 5, 128, "bf16", None, None),
    # GRPO's rollouts (grpo_llama_1b): 64 rows, contexts up to 256
    ("grpo_decode_b64_d64_bf16", 1, 64, "bf16", None, None),
]
# (B, MB) of a case, else batch 8 of up to 128 blocks (2048 keys)
KERNEL_CASE_GEOMETRY = {"grpo_decode_b64_d64_bf16": dict(B=64, MB=16)}
# (Hq, Hk) of a case, else Llama-3.2-1B's 32 / 8
KERNEL_CASE_HEADS = {"qwen3_decode_d128_g8": (32, 4),
                     "qwen3_verify_s5_d128_g8": (32, 4),
                     "qwen2_decode_d128_g6": (12, 2),
                     "qwen2_verify_s5_d128_g6": (12, 2)}


# contexts (keys, every row) of the decode case's context sweep
CTX_SWEEP = (16, 256, 1024, 2048)
# spans (keys per split) timed beside split_plan's choice
SPAN_SWEEP = (64, 128, 256, 512, 1024)
SPAN_SWEEP_CASES = ("decode_d64_bf16", "verify_s5_d64_bf16",
                    "chunk_s32_d64_bf16", "decode_d128_bf16")


def make_paged_case(S, D, kv, seed, B=8, Hq=32, Hk=8, BS=16, MB=128):
    """Operands at the engine's layout: scrambled per-row tables whose
    entries past the context point at the null page 0, ragged contexts up
    to MB * BS (2048 by default; row 0 full), consecutive positions ending
    at ctx-1."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    NB = B * MB + 1
    q = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
    if kv == "int8":
        k = torch.randint(-127, 128, (NB, BS, Hk, D), device=dev,
                          dtype=torch.int8, generator=g)
        v = torch.randint(-127, 128, (NB, BS, Hk, D), device=dev,
                          dtype=torch.int8, generator=g)
        ks = torch.rand(NB, BS, Hk, device=dev, generator=g) * 0.015 + 0.005
        vs = torch.rand(NB, BS, Hk, device=dev, generator=g) * 0.015 + 0.005
    else:
        k = torch.randn(NB, BS, Hk, D, device=dev, generator=g).bfloat16()
        v = torch.randn(NB, BS, Hk, D, device=dev, generator=g).bfloat16()
        ks = vs = None
    tables = (torch.randperm(NB - 1, device=dev, generator=g) + 1).view(
        B, MB).int()
    ctx = torch.randint(max(S, 64), MB * BS + 1, (B,), device=dev,
                        generator=g).int()
    ctx[0] = MB * BS
    pages = (ctx + BS - 1) // BS
    tables[torch.arange(MB, device=dev)[None, :] >= pages[:, None]] = 0
    pos = (ctx[:, None] - S + torch.arange(S, device=dev)[None, :]).int()
    return q, k, v, ks, vs, tables, ctx, pos


def paged_bound(q, k, ks, tables, ctx, pos, window):
    """(bound_ms, bound_by): the bytes the function must move -- q and the
    output once, and for each row the k/v (+ scales) of the positions its
    queries can attend, with their table entries -- over HBM bandwidth,
    against the score and p@v operations over the bf16 peak."""
    B, S, Hq, D = q.shape
    Hk, BS = k.shape[2], k.shape[1]
    kv_bytes = 2 * Hk * D * k.element_size() + (2 * Hk * 4 if ks is not None
                                                 else 0)
    nbytes = 2 * q.numel() * q.element_size() + ctx.numel() * 4 \
        + pos.numel() * 4
    ops = 0
    for b in range(B):
        lo = int(pos[b].min())
        hi = min(int(ctx[b]), int(pos[b].max()) + 1)
        first = max(0, lo - window + 1) if window else 0
        keys = hi - first
        nbytes += keys * kv_bytes + (-(-hi // BS) - first // BS) * 4
        ops += 4 * S * Hq * D * keys
    return roofline_ms(ops, nbytes)


def library_call(q, k, v, tables, ctx, pos, window):
    """One PyTorch call computing the same function (bf16 pools, no soft
    cap): ``scaled_dot_product_attention`` over the cache gathered by table
    (the gather is set-up, not timed).  A yardstick only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F

    B, S, Hq, D = q.shape
    idx = tables.long()
    K = idx.shape[1] * k.shape[1]
    keys = k[idx].reshape(B, K, k.shape[2], D).transpose(1, 2).contiguous()
    vals = v[idx].reshape(B, K, k.shape[2], D).transpose(1, 2).contiguous()
    kv_pos = torch.arange(K, device=q.device)
    mask = (kv_pos[None, None, :] < ctx[:, None, None]) \
        & (kv_pos[None, None, :] <= pos[:, :, None])
    if window:
        mask &= kv_pos[None, None, :] > pos[:, :, None] - window
    mask = mask[:, None]                                  # [B, 1, S, K]
    qt = q.transpose(1, 2).contiguous()

    def run():
        return F.scaled_dot_product_attention(qt, keys, vals, attn_mask=mask,
                                              enable_gqa=True)

    return run, lambda out: out.transpose(1, 2)


def kernel_phase(flush):
    import torch

    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak

    rows = []
    for i, (name, S, D, kv, cap, win) in enumerate(KERNEL_CASES):
        Hq, Hk = KERNEL_CASE_HEADS.get(name, (32, 8))
        q, k, v, ks, vs, tables, ctx, pos = make_paged_case(
            S, D, kv, seed=i, Hq=Hq, Hk=Hk,
            **KERNEL_CASE_GEOMETRY.get(name, {}))
        kw = dict(logits_soft_cap=cap, local_window_size=win)
        args = (q, k, v, ks, vs, tables, ctx, pos)
        out = pak.paged_decode_cuda(*args, **kw)
        torch.cuda.synchronize()
        ref = tpa.paged_attention_plain(*args, **kw)
        check(out.shape == ref.shape and out.dtype == q.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
        check(not bool(bad.any()),
              f"{name}: kernel disagrees with the plain version "
              f"(max_abs_err {err:.3e}, {int(bad.sum())} elements)")
        kernel_ms = time_ms(lambda: pak.paged_decode_cuda(*args, **kw), 20,
                            flush)
        # the engine step is host-bound: the kernels' own time apart from
        # the wrapper's host work (which `ms` includes where it is longer)
        device_ms = time_ms(lambda: pak.paged_decode_cuda(*args, **kw), 20,
                            flush, hide_host=True)
        plain_ms = time_ms(lambda: tpa.paged_attention_plain(*args, **kw), 5,
                           flush)
        library_ms = library_device_ms = None
        if kv == "bf16" and cap is None:
            run, back = library_call(q, k, v, tables, ctx, pos, win)
            lib_err = float((back(run()).float() - ref.float()).abs().max())
            check(lib_err <= KERNEL_ATOL * 4,
                  f"{name}: the library yardstick computes something else "
                  f"({lib_err:.3e})")
            library_ms = time_ms(run, 20, flush)
            library_device_ms = time_ms(run, 20, flush, hide_host=True)
        bound_ms, bound_by = paged_bound(q, k, ks, tables, ctx, pos, win)
        B, _, Hq, _ = q.shape
        plan = pak.split_plan(B, S, Hq, k.shape[2], tables.shape[1],
                              pak._sms(q.device), None,
                              q.dtype == torch.bfloat16)
        row = dict(case=name, S=S, D=D, Hq=Hq, Hk=Hk, kv=kv, soft_cap=cap,
                   window=win, max_abs_err=err, ms=kernel_ms,
                   device_ms=device_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms, bound_ms=bound_ms,
                   bound_by=bound_by, span=plan.span, splits=plan.splits,
                   mode=plan.mode, grid=plan.grid)
        print("kernel_case " + json.dumps(row), flush=True)
        rows.append(row)
        if name == KERNEL_CASES[0][0]:
            # the kernels' device time against the context: the fixed cost
            # and the cost per key (every row at one context length)
            by_ctx = {}
            for c in CTX_SWEEP:
                cc = torch.full_like(ctx, c)
                pc = (cc[:, None] - S + torch.arange(
                    S, device=ctx.device)[None, :]).int()
                a2 = (q, k, v, ks, vs, tables, cc, pc)
                by_ctx[c] = dict(
                    device_ms=time_ms(lambda: pak.paged_decode_cuda(*a2), 20,
                                      flush, hide_host=True),
                    bound_ms=paged_bound(q, k, ks, tables, cc, pc, None)[0])
            print("paged_ctx_sweep " + json.dumps(
                dict(case=name, by_ctx=by_ctx)), flush=True)
        if name in SPAN_SWEEP_CASES:
            # the split plan's span against its neighbours, each checked
            sweep = {}
            for span in SPAN_SWEEP:
                got = pak.paged_decode_cuda(*args, **kw, span=span)
                check(bool(torch.allclose(got.float(), out.float(),
                                          atol=KERNEL_ATOL,
                                          rtol=KERNEL_RTOL)),
                      f"{name}: span {span} disagrees with span "
                      f"{plan.span}")
                sweep[span] = time_ms(
                    lambda: pak.paged_decode_cuda(*args, **kw, span=span),
                    20, flush, hide_host=True)
            print("paged_span_sweep " + json.dumps(
                dict(case=name, plan_span=plan.span, device_ms_by_span=sweep)),
                flush=True)
    return rows


# ---------------------------------------------------------------------------
# attention kernel phase
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # (name, B, S, Hq, Hk, D, packed segments, window, soft cap); the first
    # is the SFT path's case and stands for the kernels in the JSON line
    ("sft_packed_d64", 8, 2048, 32, 8, 64, True, None, None),
    ("causal_d64", 8, 2048, 32, 8, 64, False, None, None),
    ("packed_d128", 8, 2048, 32, 8, 128, True, None, None),
    ("window256_d64", 8, 2048, 32, 8, 64, False, 256, None),
    ("packed_cap30_d64", 8, 2048, 32, 8, 64, True, None, 30.0),
    ("ragged_s1000_d64", 8, 1000, 32, 8, 64, False, None, None),
    # the Pallas flash kernel's case (ops/flash_attention.py): MHA,
    # head_dim 128, segment ids
    ("mha_packed_d128", 8, 2048, 16, 16, 128, True, None, None),
    # Qwen3-30B-A3B's attention on the MoE SFT path: GQA 32/4, head_dim 128
    ("qwen3_gqa_d128", 8, 2048, 32, 4, 128, True, None, None),
]
# DeepSeek-V2-Lite's MLA on kernel 9 (sft_deepseek): 16 / 16 heads at
# qk_head_dim 192, v's 128 columns padded with zeros to 192 as the model
# pads them; the first on the V2-Lite YAML's first batch's packing
MLA_CASES = [
    ("mla_packed_d192", 8, 2048, 16, 16, 192, True, None, None),
    ("mla_causal_d192", 8, 2048, 16, 16, 192, False, None, None),
]
MLA_V_HEAD_DIM = 128


def causal_case(rows):
    """The ``causal_d64`` row of an attention phase: pure causal rows,
    where ``scaled_dot_product_attention(is_causal=True)`` takes its fast
    path, so its ``library_ms`` is the yardstick the kernels line carries
    beside the main path's case."""
    return next(r for r in rows if r["case"] == "causal_d64")


def first_batch(yaml_path, overrides=()):
    """The first batch (e.g. [8, 2048]) the SFT recipe's loader yields for
    ``yaml_path`` and ``overrides`` (its mock data, packed)."""
    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    cfg = parse_args_and_load_config(["-c", yaml_path, *overrides])
    loader = train_ft.build_dataloader(
        cfg, cfg.dataset.instantiate(), "dataloader",
        int(cfg.get("step_scheduler.local_batch_size")),
        int(cfg.get("rng.seed")))
    return next(iter(loader))


def attn_bound(q, k, seg, pairs, backward, dv=None):
    """(bound_ms, bound_by): q, k, v, out and lse (plus dout, dq, dk, dv
    for the backward) and the segment ids moved once over HBM bandwidth,
    against 2 (D + dv) (forward) or 2 (3 D + 2 dv) (backward) * Hq flops
    per attended (q, k) pair over the bf16 peak.  ``dv`` (default D) is
    the value width: v, out, dout and dv are counted at it, so MLA's
    bound (dv 128) is that of the function, not of the padded operands."""
    B, S, Hq, D = q.shape
    dv = D if dv is None else dv
    nq, nk = q.numel() * 2, k.numel() * 2
    nv, no = nk * dv // D, nq * dv // D
    nbytes = nq + nk + nv + no + B * Hq * S * 4 + (seg.numel() * 4 if seg
                                                   is not None else 0)
    if backward:
        nbytes += no + nq + nk + nv           # dout, dq; dk, dv
    per_pair = 2 * (3 * D + 2 * dv) if backward else 2 * (D + dv)
    return roofline_ms(per_pair * Hq * pairs, nbytes)


def attn_library(q, k, v, dout, mask, causal_only, scale):
    """``scaled_dot_product_attention`` on the same operands ([B, H, S, D]
    copies made here, not timed; ``enable_gqa``; ``is_causal`` or the dense
    boolean mask, none for full attention): ``(run_fwd, run_bwd,
    to_bshd)``.  A yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    kw = dict(is_causal=True) if causal_only else dict(attn_mask=mask)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                              enable_gqa=True, **kw)

    out = fwd()
    dt = dout.transpose(1, 2).contiguous()

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)

    return fwd, bwd, lambda o: o.transpose(1, 2)


def factor(ms, library_ms):
    """A kernel's time over its library call's (None without one)."""
    return None if library_ms is None else ms / library_ms


def attention_phase(flush, seg_np, cases=ATTN_CASES, v_dim=None):
    """Kernel 9 (forward and backward) against its plain version at each
    of ``cases``, with the kernel, plain, SDPA and bound times; ``v_dim``
    zeroes v past that many columns (MLA's padded v), whose output columns
    must then come out exactly 0.  A case may carry a tenth field, the
    softmax scale (Granite's ``attention_multiplier``; default
    ``D ** -0.5``), and an eleventh, ``causal`` (default True; False is
    Qwen2.5-VL's tower).  Its ``packed`` field is True (``seg_np``'s
    segment ids), False (none) or the case's own ``[B, S]`` segment ids
    (a window batch's key padding).  A head_dim the kernels take
    zero-padded (80, 96) also gets the bound at the padded width
    (``padded_bound_ms``)."""
    import torch

    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import (
        dispatched_window,
        make_attention_mask,
    )

    dev = torch.device("cuda")
    rows = []
    for i, (name, B, S, Hq, Hk, D, packed, win, cap, *rest) in enumerate(
            cases):
        scale = rest[0] if rest else None
        causal = rest[1] if len(rest) > 1 else True
        own_seg = not isinstance(packed, bool)
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
        k = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
        v = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
        if v_dim is not None:
            v[..., v_dim:] = 0
        dout = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
        if own_seg:
            seg = torch.from_numpy(packed).to(dev).contiguous()
        else:
            seg = (torch.from_numpy(seg_np[:B, :S]).to(dev).contiguous()
                   if packed else None)
        kw = dict(causal=causal, segment_ids=seg, logits_soft_cap=cap,
                  local_window_size=win, scale=scale)
        mask = make_attention_mask(S, S, causal=causal, segment_ids_q=seg,
                                   segment_ids_kv=seg,
                                   local_window_size=win, device=dev)
        full = mask is None                 # non-causal, no segment ids
        if full:
            mask = torch.ones(1, 1, S, S, dtype=torch.bool, device=dev)
        mask = mask.expand(B, 1, S, S)
        pairs = int(mask.sum())
        valid = mask.any(-1)[:, 0]                        # [B, S] rows

        out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = sa.splash_attention_plain(q, k, v, **kw)
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()[valid]
        fwd_err = float(diff.max())
        bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()[valid]
        check(not bool(bad.any()),
              f"{name}: forward kernel disagrees with the plain version "
              f"(max_abs_err {fwd_err:.3e}, {int(bad.sum())} elements)")
        lse_err = float((lse - ref_lse).abs().transpose(1, 2)[valid].max())
        check(lse_err <= 1e-2, f"{name}: lse max_abs_err {lse_err:.3e}")
        check(bool((out[~valid] == 0).all()),
              f"{name}: rows with no key are not 0")
        if v_dim is not None:
            check(bool((out[..., v_dim:] == 0).all()),
                  f"{name}: the padded v columns' outputs are not exactly 0")

        grads = sa.flash_attn_bwd_cuda(q, k, v, ref, ref_lse, dout, **kw)
        torch.cuda.synchronize()
        refs = sa.splash_attention_bwd_plain(q, k, v, ref, ref_lse, dout,
                                             **kw)
        bwd_err, rel = 0.0, {}
        for gname, got, want in zip(("dq", "dk", "dv"), grads, refs):
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite {gname}")
            rel[gname] = float((got.float() - want.float()).norm()
                               / want.float().norm())
            bwd_err = max(bwd_err, float((got.float() - want.float())
                                         .abs().max()))
            check(rel[gname] <= GRAD_REL_L2,
                  f"{name}: backward kernel {gname} relative L2 error "
                  f"{rel[gname]:.3e} > {GRAD_REL_L2}")
        del grads, refs

        fwd_ms = time_ms(lambda: sa.flash_attn_fwd_cuda(q, k, v, **kw), 10,
                         flush)
        bwd_ms = time_ms(lambda: sa.flash_attn_bwd_cuda(
            q, k, v, ref, ref_lse, dout, **kw), 10, flush)
        fwd_plain = time_ms(lambda: sa.splash_attention_plain(q, k, v, **kw),
                            3, flush)
        bwd_plain = time_ms(lambda: sa.splash_attention_bwd_plain(
            q, k, v, ref, ref_lse, dout, **kw), 3, flush)
        fwd_lib = bwd_lib = None
        if cap is None:
            lib_fwd, lib_bwd, back = attn_library(
                q, k, v, dout, None if full else mask,
                causal and seg is None and win is None,
                D ** -0.5 if scale is None else scale)
            lib_err = float((back(lib_fwd().detach()).float() - ref.float())
                            .abs()[valid].max())
            check(lib_err <= KERNEL_ATOL * 4,
                  f"{name}: the library yardstick computes something else "
                  f"({lib_err:.3e})")
            fwd_lib = time_ms(lib_fwd, 10, flush)
            bwd_lib = time_ms(lib_bwd, 10, flush)
            del lib_fwd, lib_bwd
        fb, fby = attn_bound(q, k, seg, pairs, False, v_dim)
        bb, bby = attn_bound(q, k, seg, pairs, True, v_dim)
        row = dict(case=name, B=B, S=S, Hq=Hq, Hk=Hk, D=D,
                   packed="own" if own_seg else packed, causal=causal,
                   window=win, soft_cap=cap, scale=scale,
                   # False: attention() runs these rows on another plan
                   # (a window at least as long as the rows as causal)
                   on_path=dispatched_window(win, S) == win,
                   attended_pairs=pairs,
                   fwd=dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                            library_factor=factor(fwd_ms, fwd_lib),
                            bound_ms=fb, bound_by=fby, max_abs_err=fwd_err,
                            lse_max_abs_err=lse_err),
                   bwd=dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                            library_factor=factor(bwd_ms, bwd_lib),
                            bound_ms=bb, bound_by=bby, max_abs_err=bwd_err,
                            rel_l2=rel))
        if v_dim is not None:       # the bound at v's padded width too
            row["v_dim"] = v_dim
            for part, backward in (("fwd", False), ("bwd", True)):
                row[part]["padded_bound_ms"], row[part][
                    "padded_bound_by"] = attn_bound(q, k, seg, pairs,
                                                    backward)
        width = sa.padded_head_dim(D)
        if width is not None:       # the work the padded operands carry
            row["padded_head_dim"] = width
            qw = torch.empty(B, S, Hq, width, device="meta")
            kp = torch.empty(B, S, Hk, width, device="meta")
            for part, backward in (("fwd", False), ("bwd", True)):
                row[part]["padded_bound_ms"], row[part][
                    "padded_bound_by"] = attn_bound(qw, kp, seg, pairs,
                                                    backward)
        print("attention_case " + json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, dout, out, lse, ref, ref_lse, mask
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# flash-rung kernel phase (csrc/flash_mha_fwd.cu, csrc/flash_mha_bwd.cu)
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # (name, B, S, Hq, Hk, D, causal, packed); the kernels see MHA (kv
    # repeated to Hq, as flash_attention_bshd hands them over).  The first
    # is sft_flash's case (the bench YAML's first batch, padding rows
    # included) and stands for the kernels in the JSON line.
    ("sft_flash_packed_d64", 8, 2048, 32, 8, 64, True, True),
    ("causal_d64", 8, 2048, 32, 8, 64, True, False),
    ("full_packed_d64", 8, 2048, 32, 8, 64, False, True),
    # row 10's case: MHA, head_dim 128, segment ids
    ("mha_packed_d128", 8, 2048, 16, 16, 128, True, True),
]


def flash_phase(flush, seg_np):
    """Each flash kernel against its plain version on every row (segment 0
    attends segment 0, so padding rows are live), with kernel, plain,
    library (SDPA on the dense equality mask) and bound times."""
    import torch
    import torch.nn.functional as F

    from automodel_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rows = []
    for i, (name, B, S, Hq, Hk, D, causal, packed) in enumerate(FLASH_CASES):
        g = torch.Generator(device=dev).manual_seed(300 + i)

        def mk(h):
            return torch.randn(B, h, S, D, device=dev, generator=g).bfloat16()

        q, dout = mk(Hq), mk(Hq)
        k, v = (mk(Hk).repeat_interleave(Hq // Hk, dim=1).contiguous()
                for _ in range(2))
        seg = (torch.from_numpy(seg_np[:B, :S]).to(dev).contiguous()
               if packed else None)
        scale = D ** -0.5
        mask = fa.mha_mask(S, causal, seg, dev)
        pairs = (B * S * S if mask is None
                 else int(mask.expand(B, 1, S, S).sum()))
        pad_rows = 0 if seg is None else int((seg == 0).sum())

        out, lse = fa.flash_mha_fwd_cuda(q, k, v, seg, causal, scale)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_mha_plain(q, k, v, seg, causal, scale)
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        fwd_err = float(diff.max())
        bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
        check(not bool(bad.any()),
              f"{name}: flash forward kernel disagrees with the plain "
              f"version (max_abs_err {fwd_err:.3e}, {int(bad.sum())} "
              "elements, padding rows included)")
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= 1e-2, f"{name}: lse max_abs_err {lse_err:.3e}")

        grads = fa.flash_mha_bwd_cuda(q, k, v, ref, ref_lse, dout, seg,
                                      causal, scale)
        torch.cuda.synchronize()
        refs = fa.flash_mha_bwd_plain(q, k, v, ref, ref_lse, dout, seg,
                                      causal, scale)
        bwd_err, rel = 0.0, {}
        for gname, got, want in zip(("dq", "dk", "dv"), grads, refs):
            check(bool(torch.isfinite(got).all()),
                  f"{name}: non-finite {gname}")
            rel[gname] = float((got.float() - want.float()).norm()
                               / want.float().norm())
            bwd_err = max(bwd_err, float((got.float() - want.float())
                                         .abs().max()))
            check(rel[gname] <= GRAD_REL_L2,
                  f"{name}: flash backward kernel {gname} relative L2 error "
                  f"{rel[gname]:.3e} > {GRAD_REL_L2}")
        del grads, refs

        fwd_ms = time_ms(lambda: fa.flash_mha_fwd_cuda(
            q, k, v, seg, causal, scale), 10, flush)
        bwd_ms = time_ms(lambda: fa.flash_mha_bwd_cuda(
            q, k, v, ref, ref_lse, dout, seg, causal, scale), 10, flush)
        fwd_plain = time_ms(lambda: fa.flash_mha_plain(
            q, k, v, seg, causal, scale), 3, flush)
        bwd_plain = time_ms(lambda: fa.flash_mha_bwd_plain(
            q, k, v, ref, ref_lse, dout, seg, causal, scale), 3, flush)
        qt, kt, vt = (x.detach().clone().requires_grad_() for x in (q, k, v))
        kw = (dict(attn_mask=mask) if seg is not None
              else dict(is_causal=causal))

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                                  **kw)

        lib_out = lib_fwd()
        lib_err = float((lib_out.detach().float() - ref.float()).abs().max())
        check(lib_err <= KERNEL_ATOL * 4,
              f"{name}: the library yardstick computes something else "
              f"({lib_err:.3e})")
        fwd_lib = time_ms(lib_fwd, 10, flush)
        bwd_lib = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dout, retain_graph=True), 10, flush)
        del lib_out, qt, kt, vt
        # bytes: q, k, v (as the kernels read them: MHA), out, lse, seg;
        # the backward adds out, dout, lse read and dq, dk, dv written
        nqkv = 3 * q.numel() * 2
        nseg = 0 if seg is None else seg.numel() * 4
        fb, fby = roofline_ms(4 * D * Hq * pairs,
                              nqkv + q.numel() * 2 + lse.numel() * 4 + nseg)
        bb, bby = roofline_ms(10 * D * Hq * pairs,
                              2 * nqkv + 2 * q.numel() * 2 + lse.numel() * 4
                              + nseg)
        row = dict(case=name, B=B, S=S, Hq=Hq, Hk=Hk, D=D, causal=causal,
                   packed=packed, padding_rows=pad_rows,
                   attended_pairs=pairs,
                   fwd=dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                            library_factor=factor(fwd_ms, fwd_lib),
                            bound_ms=fb, bound_by=fby, max_abs_err=fwd_err,
                            lse_max_abs_err=lse_err),
                   bwd=dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                            library_factor=factor(bwd_ms, bwd_lib),
                            bound_ms=bb, bound_by=bby, max_abs_err=bwd_err,
                            rel_l2=rel))
        print("flash_case " + json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, dout, out, lse, ref, ref_lse, mask
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# linear-CE kernel phase
# ---------------------------------------------------------------------------
LCE_CASES = [
    # (name, T, H, V, labels); the first is the bench SFT path's case (the
    # LM head over 8 x 2048 rows) and stands for the kernels in the JSON line
    ("sft_bench", 16384, 2048, 128256, "bench"),
    ("vocab_tail", 4096, 2048, 50257, "random"),       # GPT-2's vocabulary
    ("ragged_rows", 1000, 2048, 128256, "random"),
    ("h4096", 4096, 4096, 128256, "random"),           # Llama-3-8B's width
    ("all_ignored", 4096, 2048, 128256, "ignored"),
    # the post-training phases' logprob passes: GRPO's [64, 256] rows and
    # DPO's [32, 256] per half, with their objectives' per-row cotangents
    ("grpo_t16384", 16384, 2048, 128256, "grpo"),
    ("dpo_t8192", 8192, 2048, 128256, "dpo"),
]
LCE_PARTS = ("dlogits", "dh", "dw")


# the post-training shapes' rows and cotangents (pt_lce_inputs)
PT_LCE_KINDS = ("grpo", "dpo")


def pt_lce_inputs(kind, T, V, g):
    """Labels and per-row ``(dlse, dpick)`` cotangents of the logprob pass
    at the post-training YAMLs' shapes, rows of S 256 = a 128-token prompt
    and its completion: ``grpo`` -- every completion 128 tokens (rows 127
    to 254 of a sequence supervised), the GRPO objective's cotangent of
    each token's logprob, ``(-A_b + kl_coef (1 - exp(ref - lp))) / n``
    with A_b the sequence's advantage (8 groups of 8, normalized) and
    ``ref - lp`` N(0, 0.3); ``dpo`` -- completions of 96 +- 16 tokens,
    the cotangent ``-(beta / B) sigmoid(-m_b)`` of each token of sequence
    b for margins m_b N(0, 1) (constant within a sequence).  ``dpick`` is
    that cotangent, ``dlse`` its negative, both 0 on prompt and pad rows."""
    import torch

    dev = torch.device("cuda")
    S, P = 256, 128
    B = T // S
    labels = torch.full((B, S), -100, dtype=torch.int32, device=dev)
    if kind == "grpo":
        n_comp = torch.full((B,), 128, device=dev)
        adv = torch.randn(B // 8, 8, device=dev, generator=g)
        adv = ((adv - adv.mean(1, keepdim=True))
               / (adv.std(1, keepdim=True, unbiased=False) + 1e-4))
        per_row = adv.reshape(B, 1).expand(B, S)
        delta = 0.3 * torch.randn(B, S, device=dev, generator=g)
        n = float(B * 128)
        dlp = (-per_row + 0.05 * (1 - torch.exp(delta))) / n
    else:
        n_comp = (96 + 16 * torch.randn(B, device=dev, generator=g)).clamp(
            1, 127).round().long() + 1           # + eos
        m = torch.randn(B, device=dev, generator=g)
        dlp = (-(0.1 / B) * torch.sigmoid(-m))[:, None].expand(B, S)
    pos = torch.arange(S, device=dev)[None, :]
    supervised = (pos >= P - 1) & (pos < P - 1 + n_comp[:, None])
    tokens = torch.randint(0, V, (B, S), device=dev, generator=g,
                           dtype=torch.int32)
    labels = torch.where(supervised, tokens, labels).reshape(-1)
    dpick = torch.where(supervised, dlp, torch.zeros_like(dlp)).reshape(-1)
    return labels, -dpick, dpick


def lce_bounds(T, H, V):
    """(bound_ms, bound_by) of each linear-CE function on these shapes: 2
    T H V operations per product (the forward's logits; the backward's
    recompute, dh and dW: 6 T H V in all) against the bytes each must move
    once -- h, W, the row vectors (labels, lse, pick / dlse, dpick), the
    bf16 dlogits between the backward's launches, dh and dW."""
    prod = 2.0 * T * H * V
    h, w, dl = 2.0 * T * H, 2.0 * V * H, 2.0 * T * V
    return {
        "fwd": roofline_ms(prod, h + w + 12 * T),
        "bwd": roofline_ms(3 * prod, 2 * h + 2 * w + 16 * T),
        "dlogits": roofline_ms(prod, h + w + 16 * T + dl),
        "dh": roofline_ms(prod, dl + w + h),
        "dw": roofline_ms(prod, dl + h + w),
    }


def plain_bwd_parts_ms(h, w, labels, lse, dlse, dpick):
    """Device time of each piece of the plain backward (dlogits, dh, dW
    products), summed over its row chunks in one pass (CUDA events)."""
    import torch

    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    total = dict.fromkeys(LCE_PARTS, 0.0)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    C = lce.CHUNK_ROWS
    for r0 in range(0, h.shape[0], C):
        sl = slice(r0, r0 + C)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        d = lce.dlogits_plain(h[sl], w, labels[sl], lse[sl], dlse[sl],
                              dpick[sl])
        ev[1].record()
        lce.dh_plain(d, w)
        ev[2].record()
        dw += lce.dw_plain(h[sl], d)
        ev[3].record()
        ev[3].synchronize()
        for i, part in enumerate(LCE_PARTS):
            total[part] += ev[i].elapsed_time(ev[i + 1])
        del d
    return total


def lce_case(name, T, H, V, kind, bench_labels, flush, seed, parts,
             head_divisor=1.0):
    """One linear-CE case: kernels against plain versions on the card,
    then the times; ``parts`` also times each backward kernel alone;
    ``head_divisor`` folds a logits divisor into the head (Granite's
    ``logits_scaling``, as the model hands the head to the kernels)."""
    import torch
    import torch.nn.functional as F

    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(T, H, device=dev, generator=g).bfloat16()
    ws = (torch.randn(V, H, device=dev, generator=g) * 0.02).bfloat16()
    if head_divisor != 1.0:
        ws = ws / torch.tensor(head_divisor, dtype=ws.dtype, device=dev)
    w = ws.t()                     # the model's [H, V] view of [V, H]
    if kind == "bench":
        labels = torch.from_numpy(bench_labels.reshape(-1)).to(dev).int()
        check(labels.numel() == T, f"{name}: {labels.numel()} labels != {T}")
    elif kind == "random":
        labels = torch.randint(0, V, (T,), device=dev, generator=g,
                               dtype=torch.int32)
    elif kind in PT_LCE_KINDS:
        labels, dlse, dpick = pt_lce_inputs(kind, T, V, g)
    else:
        labels = torch.full((T,), -100, dtype=torch.int32, device=dev)
    valid = (labels != -100).float()
    if kind not in PT_LCE_KINDS:
        dlse, dpick = valid, -valid      # the summed loss's cotangents
    # the loss whose gradient these cotangents are: sum of weight x CE per
    # row (the weight is dlse; -dpick on every valid row)
    weight = dlse.float()

    lse, pick = lce.linear_ce_fwd_cuda(h, w, labels)
    torch.cuda.synchronize()
    ref_lse, ref_pick = lce.lse_and_pick_plain(h, w, labels)
    fwd_err = {}
    for vname, got, ref in (("lse", lse, ref_lse), ("pick", pick, ref_pick)):
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite {vname}")
        diff = (got - ref).abs()
        fwd_err[vname] = float(diff.max())
        bad = diff > LCE_ATOL + LCE_RTOL * ref.abs()
        check(not bool(bad.any()),
              f"{name}: forward kernel {vname} disagrees with the plain "
              f"version (max_abs_err {fwd_err[vname]:.3e}, "
              f"{int(bad.sum())} rows)")

    rows = min(lce.CHUNK_ROWS, T)
    dl = torch.empty(rows, lce.padded_vocab(V), dtype=torch.bfloat16,
                     device=dev)
    lce.linear_ce_dlogits_cuda(h, ws, labels, ref_lse, dlse, dpick, 0, rows,
                               dl)
    torch.cuda.synchronize()
    ref_dl = lce.dlogits_plain(h[:rows], w, labels[:rows], ref_lse[:rows],
                               dlse[:rows], dpick[:rows]).float()
    diff = (dl[:, :V].float() - ref_dl).abs()
    dl_err = float(diff.max())
    check(not bool((diff > LCE_ATOL + LCE_RTOL * ref_dl.abs()).any()),
          f"{name}: dlogits kernel disagrees with the plain version "
          f"(max_abs_err {dl_err:.3e})")
    check(bool((dl[:, V:] == 0).all()), f"{name}: dlogits pad columns not 0")
    del ref_dl, diff

    dh, dw = lce.linear_ce_bwd_cuda(h, w, labels, ref_lse, dlse, dpick)
    torch.cuda.synchronize()
    ref_dh, ref_dw = lce.lse_and_pick_bwd_plain(h, w, labels, ref_lse, dlse,
                                                dpick)
    bwd = {}
    for gname, got, ref in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite {gname}")
        err = float((got.float() - ref.float()).abs().max())
        if kind == "ignored":
            check(bool((got == 0).all()) and bool((ref == 0).all()),
                  f"{name}: {gname} is not exactly 0 with every label "
                  f"ignored")
            rel = 0.0
        else:
            rel = float((got.float() - ref.float()).norm()
                        / ref.float().norm())
            check(rel <= LCE_GRAD_REL_L2,
                  f"{name}: backward kernel {gname} relative L2 error "
                  f"{rel:.3e} > {LCE_GRAD_REL_L2}")
        bwd[gname] = dict(rel_l2=rel, max_abs_err=err)
    del dh, dw, ref_dh, ref_dw

    args = (h, w, labels, ref_lse, dlse, dpick)
    t = dict(
        fwd=time_ms(lambda: lce.linear_ce_fwd_cuda(h, w, labels), 5, flush),
        # the forward's product alone: its epilogue with no reduction
        fwd_product=time_ms(lambda: lce.linear_ce_fwd_cuda(
            h, w, labels, timing="product"), 5, flush),
        bwd=time_ms(lambda: lce.linear_ce_bwd_cuda(*args), 3, flush),
        fwd_plain=time_ms(lambda: lce.lse_and_pick_plain(h, w, labels), 1,
                          flush, warmup=1),
        bwd_plain=time_ms(lambda: lce.lse_and_pick_bwd_plain(*args), 1,
                          flush, warmup=1))

    # the library yardstick, never called by the port: two library calls,
    # F.cross_entropy over F.linear's logits, forward and backward
    lab64 = labels.long()

    def lib_fwd():
        if kind not in PT_LCE_KINDS:
            return F.cross_entropy(F.linear(h, ws).float(), lab64,
                                   ignore_index=-100, reduction="sum")
        return (F.cross_entropy(F.linear(h, ws).float(), lab64,
                                ignore_index=-100, reduction="none")
                * weight).sum()

    ref_loss = float((weight * valid * (ref_lse - ref_pick)).sum())
    lib_loss = float(lib_fwd())
    check(abs(lib_loss - ref_loss) <= 1e-2 * max(abs(ref_loss), 1.0),
          f"{name}: the library yardstick computes something else "
          f"({lib_loss} vs {ref_loss})")
    t["fwd_library"] = time_ms(lib_fwd, 3, flush)
    hl, wl = h.detach().requires_grad_(), ws.detach().requires_grad_()
    out = F.cross_entropy(F.linear(hl, wl).float(), lab64, ignore_index=-100,
                          reduction="none" if kind in PT_LCE_KINDS
                          else "sum")
    if kind in PT_LCE_KINDS:
        out = (out * weight).sum()
    t["bwd_library"] = time_ms(
        lambda: torch.autograd.grad(out, (hl, wl), retain_graph=True), 3,
        flush)
    del out, hl, wl
    torch.cuda.empty_cache()

    bounds = lce_bounds(T, H, V)
    row = dict(case=name, T=T, H=H, V=V, labels=kind,
               head_divisor=head_divisor, valid_rows=int(valid.sum()),
               fwd=dict(ms=t["fwd"], product_ms=t["fwd_product"],
                        plain_ms=t["fwd_plain"],
                        library_ms=t["fwd_library"], bound_ms=bounds["fwd"][0],
                        bound_by=bounds["fwd"][1],
                        lse_max_abs_err=fwd_err["lse"],
                        pick_max_abs_err=fwd_err["pick"]),
               bwd=dict(ms=t["bwd"], plain_ms=t["bwd_plain"],
                        library_ms=t["bwd_library"], bound_ms=bounds["bwd"][0],
                        bound_by=bounds["bwd"][1], **{
                            f"{k}_{m}": v[m] for k, v in bwd.items()
                            for m in v}),
               dlogits_max_abs_err=dl_err)
    if parts:
        _, _, plan = lce.bwd_launch_plan(*args)
        chunks = [(r0, min(lce.CHUNK_ROWS, T - r0))
                  for r0 in range(0, T, lce.CHUNK_ROWS)]
        plain = plain_bwd_parts_ms(*args)
        library = dict(
            dlogits=None,
            dh=time_ms(lambda: [torch.mm(dl[:n, :V], ws) for _, n in chunks],
                       3, flush),
            dw=time_ms(lambda: [torch.mm(dl[:n, :V].t(), h[r0:r0 + n])
                                for r0, n in chunks], 3, flush))
        for part in LCE_PARTS:
            row[part] = dict(
                ms=time_ms(lambda: [f() for k, f in plan if k == part], 3,
                           flush),
                plain_ms=plain[part], library_ms=library[part],
                bound_ms=bounds[part][0], bound_by=bounds[part][1])
        del plan
        # no one PyTorch call computes dlogits: beside it, the time of its
        # recompute product alone (torch.mm per chunk, bf16 logits out), and
        # of the kernel without its stores and without its epilogue
        row["dlogits"]["product_library_ms"] = time_ms(
            lambda: [torch.mm(h[r0:r0 + n], w) for r0, n in chunks], 3,
            flush)
        for key, timing in (("nostore_ms", "no_store"),
                            ("product_ms", "product")):
            row["dlogits"][key] = time_ms(
                lambda: [lce.linear_ce_dlogits_cuda(
                    h, ws, labels, ref_lse, dlse, dpick, r0, n, dl,
                    timing=timing) for r0, n in chunks], 3, flush)
    print("linear_ce_case " + json.dumps(row), flush=True)
    return row


def linear_ce_phase(flush, bench_labels):
    import torch

    rows = []
    for i, (name, T, H, V, kind) in enumerate(LCE_CASES):
        rows.append(lce_case(name, T, H, V, kind, bench_labels, flush,
                             seed=200 + i,
                             parts=i == 0 or kind in PT_LCE_KINDS))
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# grouped-matmul kernel phase
# ---------------------------------------------------------------------------
def moe_widths(model):
    """``(routed experts, expert width)`` of an MoE model (the Mixtral
    families' or DeepSeek's config names)."""
    cfg = model.config
    if hasattr(cfg, "n_routed_experts"):
        return cfg.n_routed_experts, cfg.moe_intermediate_size
    return cfg.num_local_experts, model.layer_cls.expert_inter(cfg)


def moe_layer_count(model):
    """Layers with routed experts (DeepSeek's first ``k`` are dense)."""
    cfg = model.config
    return cfg.num_hidden_layers - getattr(cfg, "first_k_dense_replace", 0)


def route_indices(model, layer, x):
    """The expert ids ``[G, M, k]`` ``layer``'s router gives the rows of
    ``x [B, S, H]`` (the model's own routing, dropless)."""
    from automodel_tpu_torch.ops import moe

    cfg = model.config
    if hasattr(cfg, "n_routed_experts"):              # DeepSeek
        T = x.shape[0] * x.shape[1]
        xg, _ = moe.group_tokens(x.reshape(T, -1), min(cfg.moe_group_size,
                                                       T))
        return model._route(xg, layer.mlp.gate, cfg.num_experts_per_tok)[1]
    block = getattr(layer, layer.moe_block)
    return moe.route(x, block.gate.weight.t(),
                     num_experts_per_tok=cfg.num_experts_per_tok,
                     group_size=cfg.moe_group_size,
                     norm_topk=model._norm_topk())[2]


def routed_group_sizes(recipe, batch):
    """Route ``batch`` (the MoE YAML's first batch) through the first
    layer with routed experts of the recipe's model (its seeded weights,
    dropless; the layer's own attention on the embeddings): ``(raw sizes
    [E], block-padded sizes [E], n_pad, routed assignments)`` as
    ``sorted_expert_ffn`` lays them out."""
    import torch

    from automodel_tpu_torch.ops import moe

    model, cfg = recipe.model, recipe.model.config
    layer = model.layers[0]
    dev = recipe.device
    t = {k: torch.from_numpy(batch[k]).to(dev)
         for k in ("input_ids", "position_ids", "segment_ids")}
    with torch.no_grad():
        h = model._attention_block(
            layer, model.embed_tokens.weight[t["input_ids"]].to(
                model.compute_dtype), t["position_ids"], t["segment_ids"],
            None, None)
        idx = route_indices(model, layer, layer.post_attention_layernorm(h))
    check(cfg.moe_capacity_factor is None,
          "the MoE YAML must route dropless (moe_capacity_factor null)")
    _, sizes, padded, n_pad = moe.expert_segments(
        idx.reshape(-1), moe_widths(model)[0], 128)
    return sizes.int(), padded.int(), n_pad, idx.numel()


def gmm_bounds(sizes, m, k, n):
    """(bound_ms, bound_by) of gmm and tgmm on these group sizes: 2 (sum of
    sizes) k n operations against the bytes each must move once -- gmm:
    the grouped lhs rows, the weights of the non-empty groups and the whole
    output [m, n]; tgmm: the grouped rows of lhs and dout and the output
    [E, k, n]."""
    S = int(sizes.sum())
    nonempty = int((sizes > 0).sum())
    ops = 2.0 * S * k * n
    return {
        "gmm": roofline_ms(ops, 2.0 * (S * k + nonempty * k * n + m * n)),
        "tgmm": roofline_ms(ops, 2.0 * (S * k + S * n
                                        + sizes.numel() * k * n)),
    }


def gmm_library(kind, lhs, rhs, dout, ends):
    """One PyTorch call computing the same function, as a yardstick the
    port never calls: ``torch._grouped_mm`` where this torch has it (rows
    past the groups are not defined there, so only the grouped rows are
    compared).  ``(run, None)`` or ``(None, reason)``."""
    import torch

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if kind == "gmm":
        def run():
            return fn(lhs, rhs, offs=ends)
    elif kind == "dlhs":
        def run():
            return fn(dout, rhs.transpose(-2, -1), offs=ends)
    else:
        def run():
            return fn(lhs.t(), dout, offs=ends)
    try:
        run()
        torch.cuda.synchronize()
    except Exception as e:       # a yardstick that refuses these operands
        return None, f"torch._grouped_mm refused: {str(e).splitlines()[0]}"
    return run, None


def gmm_case(name, sizes, m, k, n, flush, seed):
    """One grouped-matmul case at the main path's widths: gmm, its
    transposed-rhs form (the backward's dlhs) and tgmm against the plain
    versions, then the kernel, plain, library and bound times."""
    import torch

    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import gmm_kernel as gk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    E = sizes.numel()
    lhs = torch.randn(m, k, device=dev, generator=g).bfloat16()
    rhs = (torch.randn(E, k, n, device=dev, generator=g) * 0.02).bfloat16()
    dout = torch.randn(m, n, device=dev, generator=g).bfloat16()
    gs = sizes.to(dev)
    total = int(sizes.sum())
    empty = [int(e) for e in torch.nonzero(sizes == 0)[:, 0]]
    runs = {
        "gmm": (lambda: gk.gmm_cuda(lhs, rhs, gs),
                lambda: gk.gmm_plain(lhs, rhs, gs)),
        "dlhs": (lambda: gk.gmm_cuda(dout, rhs, gs, trans_rhs=True),
                 lambda: gk.gmm_plain(dout, rhs, gs, trans_rhs=True)),
        "tgmm": (lambda: gk.tgmm_cuda(lhs, dout, gs),
                 lambda: gk.tgmm_plain(lhs, dout, gs)),
    }
    ends = torch.cumsum(gs, 0, dtype=torch.int32)
    bounds = gmm_bounds(sizes, m, k, n)
    # dlhs is gmm(dout [m, n], rhs^T): the same work with k and n swapped
    bounds["dlhs"] = gmm_bounds(sizes, m, n, k)["gmm"]
    row = dict(case=name, m=m, k=k, n=n, E=E, rows_in_groups=total,
               empty_groups=len(empty), max_group=int(sizes.max()))
    for kind, (kernel, plain) in runs.items():
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        check(bool(torch.isfinite(got).all()), f"{name} {kind}: non-finite")
        rel = float((got.float() - ref.float()).norm()
                    / ref.float().norm().clamp(min=1e-30))
        err = float((got.float() - ref.float()).abs().max())
        check(rel <= GMM_REL_L2,
              f"{name} {kind}: kernel vs plain relative L2 {rel:.3e} > "
              f"{GMM_REL_L2}")
        if kind == "tgmm":
            check(all(bool((got[e] == 0).all()) for e in empty),
                  f"{name}: an empty group's tgmm block is not exactly 0")
        else:
            check(bool((got[total:] == 0).all()),
                  f"{name} {kind}: rows past the groups are not 0")
        lib, why = gmm_library(kind, lhs, rhs, dout, ends)
        lib_ms = None
        if lib is not None:
            lib_out, lib_ref = lib(), ref
            if kind != "tgmm":
                lib_out, lib_ref = lib_out[:total], ref[:total]
            lib_rel = float((lib_out.float() - lib_ref.float()).norm()
                            / lib_ref.float().norm().clamp(min=1e-30))
            if lib_rel <= 4 * GMM_REL_L2:
                lib_ms = time_ms(lib, 10, flush)
            else:
                why = (f"torch._grouped_mm computes something else here "
                       f"(relative L2 {lib_rel:.3e})")
            del lib_out
        del got, ref
        row[kind] = dict(
            ms=time_ms(kernel, 10, flush),
            plain_ms=time_ms(plain, 1, flush, warmup=1),
            library_ms=lib_ms, library_note=why,
            bound_ms=bounds[kind][0], bound_by=bounds[kind][1],
            rel_l2=rel, max_abs_err=err)
    print("gmm_case " + json.dumps(row), flush=True)
    del lhs, rhs, dout
    torch.cuda.empty_cache()
    return row


# the multi-tenant LoRA delta's two rank-8 products on the gmm kernel
# (ops/lora_gmm.py) at the serving_features phase's shapes: m = B x W rows
# (8 decode rows, 8 x 32 prefill rows) of Llama-3.2-1B's q_proj (K 2048,
# N 8; then K 8, N 2048) over E = 17 slots (16 tenants + the zero slot 0),
# rows of a mixed batch round-robin over tenants 1..4 and base
LORA_RANK = 8
LORA_GMM_CASES = [
    # (name, rows per batch row, K, N)
    ("lora_a_m8", 1, 2048, LORA_RANK), ("lora_b_m8", 1, LORA_RANK, 2048),
    ("lora_a_m256", 32, 2048, LORA_RANK), ("lora_b_m256", 32, LORA_RANK, 2048),
]


def lora_gmm_phase(flush):
    """The gmm kernel at the rank-8 shapes: against its plain version, with
    kernel, plain, library (``torch._grouped_mm``) and bound times
    (``lora_gmm_case`` lines)."""
    import torch

    from automodel_tpu_torch.ops import gmm_kernel as gk

    dev = torch.device("cuda")
    E, B = 17, 8
    ids = torch.tensor([(i % 5) for i in range(B)])      # 0 = base
    rows = []
    for i, (name, W, k, n) in enumerate(LORA_GMM_CASES):
        g = torch.Generator(device=dev).manual_seed(400 + i)
        m = B * W
        sizes = torch.bincount(ids.repeat_interleave(W), minlength=E).int()
        lhs = torch.randn(m, k, device=dev, generator=g).bfloat16()
        rhs = (torch.randn(E, k, n, device=dev, generator=g) * 0.02
               ).bfloat16()
        rhs[0] = 0
        gs = sizes.to(dev)
        got = gk.gmm_cuda(lhs, rhs, gs)
        torch.cuda.synchronize()
        ref = gk.gmm_plain(lhs, rhs, gs)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        rel = float((got.float() - ref.float()).norm()
                    / ref.float().norm().clamp(min=1e-30))
        err = float((got.float() - ref.float()).abs().max())
        check(rel <= GMM_REL_L2, f"{name}: kernel vs plain relative L2 "
              f"{rel:.3e} > {GMM_REL_L2}")
        check(bool((got[:int(sizes[0])] == 0).all()),
              f"{name}: the zero slot's rows are not exactly 0")
        ends = torch.cumsum(gs, 0, dtype=torch.int32)
        lib, why = gmm_library("gmm", lhs, rhs, None, ends)
        lib_ms = None
        if lib is not None:
            lib_rel = float((lib().float() - ref.float()).norm()
                            / ref.float().norm().clamp(min=1e-30))
            if lib_rel <= 4 * GMM_REL_L2:
                lib_ms = time_ms(lib, 20, flush)
            else:
                why = (f"torch._grouped_mm computes something else here "
                       f"(relative L2 {lib_rel:.3e})")
        bound_ms, bound_by = gmm_bounds(sizes, m, k, n)["gmm"]
        row = dict(case=name, m=m, k=k, n=n, E=E,
                   group_sizes=sizes.tolist(), rel_l2=rel, max_abs_err=err,
                   ms=time_ms(lambda: gk.gmm_cuda(lhs, rhs, gs), 20, flush),
                   device_ms=time_ms(lambda: gk.gmm_cuda(lhs, rhs, gs), 20,
                                     flush, hide_host=True),
                   plain_ms=time_ms(lambda: gk.gmm_plain(lhs, rhs, gs), 5,
                                    flush),
                   library_ms=lib_ms, library_note=why, bound_ms=bound_ms,
                   bound_by=bound_by)
        print("lora_gmm_case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def skewed_sizes(E, routed, seed):
    """Group sizes of a skewed routing of ``routed`` rows over ``E``
    experts, from ``seed``: 40 experts of 1-127 rows, 6 taking 10 shares of
    the rest each, the others one share each (multinomial)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    order = rng.permutation(E)
    sizes = np.zeros(E, np.int64)
    tiny, hot = order[:40], order[40:46]
    sizes[tiny] = rng.integers(1, 128, tiny.size)
    share = np.ones(E)
    share[tiny] = 0
    share[hot] = 10
    sizes += rng.multinomial(routed - int(sizes.sum()), share / share.sum())
    return torch.from_numpy(sizes).int()


def gmm_phase(recipe, batch):
    """The grouped-matmul kernels at the MoE SFT path's shapes: the group
    sizes of the first batch routed through layer 0 (both expert products:
    k, n = 2048, 768 and 768, 2048), then ragged cases -- one expert taking
    every routed row, the raw (unpadded) routed sizes with empty experts
    (the first, two inside and the last two) so that row tiles straddle
    groups, and a skewed routing as a trained router gives it (seeded raw
    sizes: 40 experts of 1-127 rows, 6 of about 10x the others' mean),
    each with rows past the groups."""
    import torch

    cfg = recipe.model.config
    E, I = moe_widths(recipe.model)
    H = cfg.hidden_size
    sizes, padded, n_pad, routed = routed_group_sizes(recipe, batch)
    sizes, padded = sizes.cpu(), padded.cpu()
    check(int(sizes.sum()) == routed,
          f"layer 0 routed {int(sizes.sum())} assignments of {routed} "
          "(dropless: none may drop)")
    print(f"gmm: the first routed layer on the first batch routes {routed}"
          f" assignments (T x k) to {int((sizes > 0).sum())} of {E} experts,"
          f" {int(sizes.min())}-{int(sizes.max())} each; "
          f"{int(padded.sum())} block-padded rows in a buffer of {n_pad}; "
          f"sizes {sizes.tolist()}", flush=True)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    tag = "v2lite_" if hasattr(cfg, "n_routed_experts") else ""
    cases = [(f"{tag}routed_gate_up", padded, n_pad, H, I),
             (f"{tag}routed_down", padded, n_pad, I, H)]
    if not tag:
        # Qwen3-30B-A3B's ragged layouts (the routed shapes alone for
        # DeepSeek-V2-Lite)
        hot = torch.zeros_like(sizes)
        hot[37] = routed
        ragged = sizes.clone()
        ragged[[0, 5, 64, 126, 127]] = 0
        cases += [("hot_expert", hot, n_pad, H, I),
                  ("ragged_empty", ragged, n_pad, H, I),
                  ("skewed_small", skewed_sizes(E, routed, seed=17), n_pad,
                   H, I)]
    rows = [gmm_case(name, gs, m, k, n, flush, seed=300 + i)
            for i, (name, gs, m, k, n) in enumerate(cases)]
    del flush
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# quantized-matmul kernel phases
# ---------------------------------------------------------------------------
QDOT_SHAPES = [
    # (projection, k, n) of Llama-3.2-1B's layers at m = 8 x 2048 tokens
    ("q_o_proj", 2048, 2048), ("k_v_proj", 2048, 512),
    ("gate_up_proj", 2048, 8192), ("down_proj", 8192, 2048)]
# the serving engine's rows a step: 8 decode rows, a 256-row prefill chunk
SERVE_QDOT_ROWS = (8, 256)
QDOT_PAIRS = {   # (a, b) operand types of each product (_gemm_dtypes)
    ("float8", "forward"): ("float8_e4m3fn", "float8_e4m3fn"),
    ("float8", "dgrad"): ("float8_e5m2", "float8_e4m3fn"),
    ("float8", "wgrad"): ("float8_e4m3fn", "float8_e5m2"),
    ("int8", "forward"): ("int8", "int8"),
    ("int8", "dgrad"): ("int8", "int8"),
    ("int8", "wgrad"): ("int8", "int8"),
}


def qdot_cases_list():
    """(name, dtype, recipe, orientation, m, k, n) of the qdot cases: the
    sft_fp8 products (float8 tensorwise; each Llama projection forward,
    dgrad and wgrad); the four operand pairs x both recipes at the gate/up
    shape; a ragged m for each pair; the int8 products of the sft_moe_fp8
    path (Qwen3-30B-A3B attention: q 2048 -> 4096, o 4096 -> 2048).  A
    projection K_in -> N_out gives the forward (k, n) = (K_in, N_out), the
    dgrad (N_out, K_in) and the wgrad (K_in, N_out) contracting over the m
    tokens.  The first stands for the kernel in the JSON line."""
    M = 16384

    def kn(o, k_in, n_out):
        return (n_out, k_in) if o == "dgrad" else (k_in, n_out)

    cases = [(f"sft_fp8_{p}_{o}", "float8", "tensorwise", o, M,
              *kn(o, k, n))
             for p, k, n in QDOT_SHAPES
             for o in ("forward", "dgrad", "wgrad")]
    for dtype, o in (("float8", "forward"), ("float8", "dgrad"),
                     ("float8", "wgrad"), ("int8", "forward")):
        pair = "_".join(t.removeprefix("float8_")
                        for t in QDOT_PAIRS[(dtype, o)])
        cases.append((f"{pair}_rowwise_gate_up", dtype, "rowwise", o, M,
                      *kn(o, 2048, 8192)))
        cases.append((f"{pair}_ragged_m", dtype, "tensorwise", o, M - 37,
                      2048, 2048))
    cases += [(f"sft_moe_fp8_{p}_{o}", "int8", "tensorwise", o, M,
               *kn(o, k, n))
              for p, k, n in (("q_proj", 2048, 4096), ("o_proj", 4096, 2048))
              for o in ("forward", "dgrad", "wgrad")]
    # serve_fp8: the engine's forwards at a decode step (8 rows) and a
    # prefill chunk (8 x 32 rows)
    cases += [(f"serve_fp8_{p}_m{m}", "float8", "tensorwise", "forward", m,
               k, n)
              for m in SERVE_QDOT_ROWS for p, k, n in QDOT_SHAPES]
    return cases


def qdot_operands(orientation, m, k, n, seed):
    """bf16 operands as the training products hand them to qdot: forward
    x [m, k] @ W^T (W [n, k], an nn.Linear weight), dgrad g [m, k] @ W
    (W [k, n]), wgrad x^T @ g contracting over the m token rows (a is the
    [k, m] view of x [m, k], b is g [m, n]; the product is [k, n])."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g)
                * scale).bfloat16()

    if orientation == "forward":
        return t(m, k), t(n, k, scale=0.02).t()
    if orientation == "dgrad":
        return t(m, k), t(k, n, scale=0.02)
    return t(m, k).t(), t(m, n)       # [k, m] M-major, [m, n]: K = m


def qdot_library(a, b, sa, sb, a_q, b_q):
    """One PyTorch call on the quantized operands, a yardstick the port
    never calls: ``torch._scaled_mm`` for fp8 (a row-major, b column-major,
    the scales; bf16 out), ``torch._int_mm`` for int8 (int32 out, unscaled).
    Quantizing is not timed.  ``(run, to_fp32, None)`` or ``(None, None,
    reason)``."""
    import torch

    from automodel_tpu_torch.ops.quant import quant_cast

    aq = quant_cast(a, sa, a_q).contiguous()
    bq = quant_cast(b, sb, b_q).t().contiguous().t()
    m = aq.shape[0]
    if m % 16 and a_q != torch.int8 and sa.numel() == 1:
        # _scaled_mm takes rows in multiples of 16: the decode rows padded
        # with zero codes (their outputs dropped)
        aq = torch.cat([aq, aq.new_zeros(16 - m % 16, aq.shape[1])])
    if a_q == torch.int8:
        fn = getattr(torch, "_int_mm", None)
        if fn is None:
            return None, None, f"torch {torch.__version__} has no _int_mm"

        def run():
            return fn(aq, bq)

        def to_fp32(out):
            return out.float() * sa * sb
    else:
        fn = getattr(torch, "_scaled_mm", None)
        if fn is None:
            return None, None, f"torch {torch.__version__} has no _scaled_mm"
        # tensorwise: 0-dim scales; rowwise: [m, 1] and [1, n]
        scale_a = sa.reshape(()) if sa.numel() == 1 else sa.contiguous()
        scale_b = sb.reshape(()) if sb.numel() == 1 else sb.contiguous()

        def run():
            return fn(aq, bq, scale_a=scale_a, scale_b=scale_b,
                      out_dtype=torch.bfloat16)

        def to_fp32(out):
            return out[:m].float()
    try:
        run()
        torch.cuda.synchronize()
    except Exception as e:       # a yardstick that refuses these operands
        return None, None, (f"{fn.__name__} refused: "
                            f"{str(e).splitlines()[0][:160]}")
    return run, to_fp32, None


def qdot_case(name, dtype, recipe, orientation, m, k, n, flush, seed):
    """One qdot case: the kernel (fp32 out) against the plain version on
    the same scales -- int8 bit-identical, fp8 within QDOT_FP8_REL_L2 --
    then the kernel's time writing bf16 (as the training path does), the
    plain version's, the library call's, bf16 torch.matmul's and the
    bound."""
    import torch

    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import _operand_scales

    a_q, b_q = (getattr(torch, t) for t in QDOT_PAIRS[(dtype, orientation)])
    a, b = qdot_operands(orientation, m, k, n, seed)
    sa, sb = _operand_scales(a, b, a_q, b_q, recipe == "rowwise")
    got = qk.qdot_cuda(a, b, sa, sb, a_q, b_q)
    torch.cuda.synchronize()
    ref = qk.qdot_plain(a, b, sa, sb, a_q, b_q)
    check(bool(torch.isfinite(got).all()), f"qdot {name}: non-finite")
    err = float((got - ref).abs().max())
    rel = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    if a_q == torch.int8:
        check(torch.equal(got, ref),
              f"qdot {name}: int8 kernel is not bit-identical to the plain "
              f"version (max_abs_err {err:.3e})")
    else:
        check(rel <= QDOT_FP8_REL_L2,
              f"qdot {name}: kernel vs plain relative L2 {rel:.3e} > "
              f"{QDOT_FP8_REL_L2}")
    lib, to_fp32, why = qdot_library(a, b, sa, sb, a_q, b_q)
    lib_ms = None
    if lib is not None:
        lib_rel = float((to_fp32(lib()) - ref).norm()
                        / ref.norm().clamp(min=1e-30))
        if lib_rel <= 1e-2:
            lib_ms = time_ms(lib, 10, flush)
        else:
            why = f"the library computes something else ({lib_rel:.3e})"
    del got, ref
    kernel = lambda: qk.qdot_cuda(a, b, sa, sb, a_q, b_q,    # noqa: E731
                                  out_dtype=torch.bfloat16)
    # the call's two launches alone: the pack (quantize) and the product
    _, plan = qk.qdot_launch_plan(a, b, sa, sb, a_q, b_q,
                                  out_dtype=torch.bfloat16)
    steps = dict(plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scales = 4.0 * (sa.numel() + sb.numel())
    nbytes = 2.0 * (m * k + k * n + m * n) + scales
    bound_ms, bound_by = roofline_ms(2.0 * m * k * n, nbytes,
                                     ops_per_s=INT8_FP8_OPS_PER_S)
    # the pack reads bf16 and writes codes; the product reads codes and
    # writes bf16
    pack_bound = roofline_ms(0.0, 3.0 * (m * k + k * n) + scales)
    product_bound = roofline_ms(2.0 * m * k * n,
                                1.0 * (m * k + k * n) + 2.0 * m * n + scales,
                                ops_per_s=INT8_FP8_OPS_PER_S)
    row = dict(case=name, dtype=dtype, recipe=recipe,
               orientation=orientation, a=str(a_q).removeprefix("torch."),
               b=str(b_q).removeprefix("torch."), m=m, k=k, n=n,
               max_abs_err=err, rel_l2=rel,
               bit_identical=a_q == torch.int8,
               splits=qk.split_plan(a.shape[0], b.shape[1], a.shape[1], a_q,
                                    sms)[0],
               ms=time_ms(kernel, 10, flush),
               pack_ms=time_ms(steps["pack"], 10, flush),
               product_ms=time_ms(steps["product"], 10, flush),
               pack_bound_ms=pack_bound[0], product_bound_ms=product_bound[0],
               product_bound_by=product_bound[1],
               plain_ms=time_ms(lambda: qk.qdot_plain(a, b, sa, sb, a_q, b_q),
                                1, flush, warmup=1),
               library_ms=lib_ms, library_note=why,
               bf16_matmul_ms=time_ms(lambda: torch.matmul(a, b), 10, flush),
               bound_ms=bound_ms, bound_by=bound_by)
    print("qdot_case " + json.dumps(row), flush=True)
    del a, b
    torch.cuda.empty_cache()
    return row


def qdot_accumulation():
    """How far the fp8 product's sums are from float64 ones, with and
    without the per-stage fp32 promotion (csrc/qdot.cu): all-positive e4m3
    operands (uniform in [0, 1), so no error cancels) at K 8192 and 16384,
    [4096, 2048] out (no split K), relative L2 of the fp32 output against
    the plain version's float64 sums of the same codes."""
    import torch

    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import _operand_scales

    e4 = torch.float8_e4m3fn
    g = torch.Generator(device="cuda").manual_seed(450)
    row = dict(m=4096, n=2048)
    for k in (8192, 16384):
        a = torch.rand(4096, k, device="cuda", generator=g).bfloat16()
        b = torch.rand(2048, k, device="cuda", generator=g).bfloat16().t()
        sa, sb = _operand_scales(a, b, e4, e4, False)
        ref = qk.qdot_plain(a, b, sa, sb, e4, e4)
        for promote in (True, False):
            out, plan = qk.qdot_launch_plan(a, b, sa, sb, e4, e4,
                                            promote=promote)
            for _, launch in plan:
                launch()
            torch.cuda.synchronize()
            row[f"k{k}_{'promoted' if promote else 'raw'}_rel_l2"] = float(
                (out - ref).norm() / ref.norm())
        del a, b, ref, out
        torch.cuda.empty_cache()
    print("qdot_fp8_accumulation " + json.dumps(row), flush=True)
    for k in (8192, 16384):
        check(row[f"k{k}_promoted_rel_l2"] <= QDOT_FP8_REL_L2,
              f"qdot fp8 sums at K {k}: relative L2 "
              f"{row[f'k{k}_promoted_rel_l2']:.3e} > {QDOT_FP8_REL_L2}")
    return row


def qdot_phase(flush):
    rows = [qdot_case(*c, flush, seed=400 + i)
            for i, c in enumerate(qdot_cases_list())]
    qdot_accumulation()
    return rows


def gmm_quant_case(name, sizes, m, k, n, qdtype, flush, seed,
                   dlhs=False):
    """One gmm_quant case at the MoE path's widths, tensorwise per-group
    scales (the path's recipe): the kernel (its quantize pass, grouped
    product and rescale) against the plain version on the same scales --
    int8 bit-identical, fp8 within QDOT_FP8_REL_L2, rows past the groups
    exactly 0 -- then the kernel's time writing bf16, the whole wrapper's
    (scales and kernel), the plain version's, the library's (on codes
    quantized beforehand, not timed), the bf16 gmm kernel's and the bound.
    ``dlhs``: the backward's product, an e5m2 gradient against the experts
    read as the transpose view of their own storage."""
    import torch

    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops.quant import quant_cast

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    E = sizes.numel()
    total = int(sizes.sum())
    lhs = torch.randn(m, k, device=dev, generator=g).bfloat16()
    lhs[total:] = 0                    # the sorted buffer's tail rows
    experts = (torch.randn(E, n, k, device=dev, generator=g)
               * 0.02).bfloat16()
    # the forward's experts [E, k, n]; the backward's rhs^T is the transpose
    # view of its own [E, n, k] weights
    rhs = experts.transpose(1, 2) if dlhs else \
        experts.transpose(1, 2).contiguous()
    gs = sizes.to(dev)
    a_q = torch.float8_e5m2 if dlhs else qdtype
    s_lhs = gq.lhs_scales(lhs, gs, a_q, "tensorwise")
    s_rhs = gq.rhs_scales(rhs, qdtype, "tensorwise").contiguous()
    args = (lhs, rhs, gs, s_lhs, s_rhs, a_q, qdtype)
    got = gq.gmm_quant_cuda(*args)
    torch.cuda.synchronize()
    ref = gq.gmm_quant_plain(*args)
    check(bool(torch.isfinite(got).all()), f"gmm_quant {name}: non-finite")
    check(bool((got[total:] == 0).all()),
          f"gmm_quant {name}: rows past the groups are not 0")
    err = float((got - ref).abs().max())
    rel = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    if qdtype == torch.int8:
        check(torch.equal(got, ref),
              f"gmm_quant {name}: int8 kernel is not bit-identical to the "
              f"plain version (max_abs_err {err:.3e})")
    else:
        check(rel <= QDOT_FP8_REL_L2,
              f"gmm_quant {name}: kernel vs plain relative L2 {rel:.3e} > "
              f"{QDOT_FP8_REL_L2}")
    why = None
    lib_ms = None
    fn = getattr(torch, "_scaled_grouped_mm", None)
    if qdtype == torch.int8:
        why = "no PyTorch grouped int8 product"
    elif fn is None:
        why = f"torch {torch.__version__} has no _scaled_grouped_mm"
    else:
        ends = torch.cumsum(gs, 0, dtype=torch.int32)
        lhs_q = quant_cast(lhs, s_lhs, a_q)
        # [E, k, n] column-major codes and rowwise scales, as it takes them
        rhs_q = quant_cast(experts.transpose(1, 2), s_rhs, qdtype)
        sa_lib = s_lhs[:, 0].contiguous()
        sb_lib = s_rhs.expand(E, 1, n)[:, 0].contiguous()

        def lib():
            return fn(lhs_q, rhs_q, sa_lib, sb_lib, offs=ends,
                      out_dtype=torch.bfloat16)
        try:
            out = lib()
            torch.cuda.synchronize()
            lib_rel = float((out[:total].float() - ref[:total]).norm()
                            / ref[:total].norm().clamp(min=1e-30))
            del out
            if lib_rel <= 1e-2:
                lib_ms = time_ms(lib, 10, flush)
            else:
                why = (f"_scaled_grouped_mm computes something else here "
                       f"({lib_rel:.3e})")
        except Exception as e:   # a yardstick that refuses these operands
            why = f"_scaled_grouped_mm refused: {str(e).splitlines()[0][:160]}"
    del got, ref
    nonempty = int((sizes > 0).sum())
    scales = 4.0 * (m + E * n)
    bound_ms, bound_by = roofline_ms(
        2.0 * total * k * n, 2.0 * (total * k + nonempty * k * n + m * n)
        + scales, ops_per_s=INT8_FP8_OPS_PER_S)
    # the two passes' own floor: the pack reads every bf16 row and expert
    # and writes their codes; the product reads the groups' codes and
    # writes bf16
    codes = 1.0 * (m * k + E * k * n)
    two_pass_floor_ms = (3.0 * codes + 1.0 * (total * k + nonempty * k * n)
                         + 2.0 * m * n + 2 * scales) / HBM_BYTES_PER_S * 1e3
    # the call's two launches alone: the pack (quantize) and the product
    _, plan = gq.gmm_quant_launch_plan(*args[:-1], qdtype, torch.bfloat16)
    steps = dict(plan)
    bf16_rhs = experts if dlhs else rhs
    row = dict(
        case=name, a=str(a_q).removeprefix("torch."),
        b=str(qdtype).removeprefix("torch."), m=m, k=k, n=n, E=E,
        rows_in_groups=total, empty_groups=int((sizes == 0).sum()),
        max_group=int(sizes.max()), max_abs_err=err, rel_l2=rel,
        bit_identical=qdtype == torch.int8,
        ms=time_ms(lambda: gq.gmm_quant_cuda(*args[:-1], qdtype,
                                             torch.bfloat16), 10, flush),
        pack_ms=time_ms(steps["pack"], 10, flush),
        product_ms=time_ms(steps["product"], 10, flush),
        wrapper_ms=time_ms(lambda: gq._quantized_gmm(
            lhs, rhs, gs, a_qdtype=a_q, b_qdtype=qdtype,
            recipe="tensorwise", out_dtype=torch.bfloat16, impl="kernel"),
            5, flush),
        plain_ms=time_ms(lambda: gq.gmm_quant_plain(*args), 1, flush,
                         warmup=1),
        library_ms=lib_ms, library_note=why,
        bf16_gmm_ms=time_ms(lambda: gk.gmm_cuda(lhs, bf16_rhs, gs,
                                                trans_rhs=dlhs), 10, flush),
        bound_ms=bound_ms, bound_by=bound_by,
        two_pass_floor_ms=two_pass_floor_ms, recipe="tensorwise",
        dtype="int8" if qdtype == torch.int8 else "float8",
        product="dlhs" if dlhs else "forward")
    print("gmm_quant_case " + json.dumps(row), flush=True)
    del lhs, experts, rhs, args, plan, steps
    torch.cuda.empty_cache()
    return row


def gmm_quant_phase(recipe, batch):
    """gmm_quant at the four gmm_case group layouts of the MoE path
    (routed gate/up, routed down, one hot expert, ragged with empty
    experts), int8 (the sft_moe_fp8 recipe) and e4m3 each, plus the
    backward's dlhs product (e5m2 x e4m3) on the routed gate/up layout."""
    import torch

    cfg = recipe.model.config
    E, I = moe_widths(recipe.model)
    H = cfg.hidden_size
    sizes, padded, n_pad, routed = routed_group_sizes(recipe, batch)
    sizes, padded = sizes.cpu(), padded.cpu()
    hot = torch.zeros_like(sizes)
    hot[37] = routed
    ragged = sizes.clone()
    ragged[[0, 5, 64, 126, 127]] = 0
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    layouts = [("routed_gate_up", padded, H, I),
               ("routed_down", padded, I, H),
               ("hot_expert", hot, H, I),
               ("ragged_empty", ragged, H, I)]
    rows = []
    for qdtype in (torch.int8, torch.float8_e4m3fn):
        for i, (name, gs, k, n) in enumerate(layouts):
            label = f"{name}_{'int8' if qdtype == torch.int8 else 'e4m3'}"
            rows.append(gmm_quant_case(label, gs, n_pad, k, n, qdtype, flush,
                                       seed=500 + len(rows)))
    rows.append(gmm_quant_case("routed_gate_up_dlhs_e5m2_e4m3", padded,
                               n_pad, I, H, torch.float8_e4m3fn, flush,
                               seed=500 + len(rows), dlhs=True))
    del flush
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------
def engine_phase(yaml_path=None, label="engine", flush=None, model=None,
                 layers=None):
    """A model at full width through the port's DecodeEngine (the serve
    YAML ``yaml_path``, default Llama-3.2-1B's; weights from seed 0, or
    ``model`` as given, built by the caller): the
    first step's logits through every kernel against every plain version,
    16 requests of 64-1024 prompt tokens after a warm-up with the counts
    zeroed just before and read just after (paged decode = layers x steps;
    gmm = 3 x routed layers x steps for an MoE model, else 0), then
    profiled prefill and decode windows.  Llama: a shorter int8-KV run
    too.  An MoE model: first the gmm kernel at the engine's routed
    shapes (``flush`` given), last the prefix cache on and off.
    ``layers`` cuts the YAML model's depth."""
    import gc

    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        RequestState,
        build_serving_config,
    )

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = load_yaml_config(yaml_path or SERVE_YAML)
    if layers is not None:
        cfg.set_by_dotted("model.config.num_hidden_layers", layers)
    scfg = build_serving_config(cfg)
    gen = GenerationConfig(**cfg.generation.to_dict())
    t0 = time.perf_counter()
    if model is None:
        model = cfg.model.instantiate(seed=0, device="cuda")
    torch.cuda.synchronize()
    mcfg = model.config
    L = mcfg.num_hidden_layers
    moe = hasattr(model, "gmm_impl")
    routed = 3 * moe_layer_count(model) if moe else 0
    ffn = (f"{moe_widths(model)[0]} experts of {moe_widths(model)[1]}, "
           f"top-{mcfg.num_experts_per_tok}" if moe
           else f"ffn {mcfg.intermediate_size}")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"{label}: {type(model).__name__} widths (vocab {mcfg.vocab_size},"
          f" hidden {mcfg.hidden_size}, {ffn}, layers {L}, heads "
          f"{mcfg.num_attention_heads}/{mcfg.num_key_value_heads}, head_dim "
          f"{mcfg.head_dim}), {model.num_params} params {model.param_dtype} "
          f"({weight_bytes} bytes; {resident} bytes resident before), built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    gmm_rows, gmm_quant_rows = [], []
    if moe:
        E, inter = moe_widths(model)
        for i, (name, tokens) in enumerate(SERVE_GMM_CASES):
            padded, n_pad = seeded_routing_sizes(
                tokens, E, mcfg.num_experts_per_tok, 400 + i)
            gmm_rows.append(gmm_case(name, padded, n_pad, mcfg.hidden_size,
                                     inter, flush, seed=410 + i))
            # kernel 7 (e4m3) at the same groups: the fp8 leg's experts
            gmm_quant_rows.append(gmm_quant_case(
                f"{name}_e4m3", padded, n_pad, mcfg.hidden_size, inter,
                torch.float8_e4m3fn, flush, seed=420 + i))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, mcfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1025, 16)]

    # first step: every kernel (paged decode; gmm) against its plain
    # version, chosen by argument
    firsts = {}
    for impl in ("plain", "kernel"):
        if moe:
            model.gmm_impl = impl
        eng = DecodeEngine(model, scfg, generation=gen, attn_impl=impl)
        for p in prompts:
            eng.submit(p)
        eng.step()
        firsts[impl] = eng.last_logits.clone()
        del eng
    if moe:
        model.gmm_impl = None
    torch.cuda.empty_cache()
    ref, got = firsts["plain"], firsts["kernel"]
    check(bool(torch.isfinite(got).all()),
          f"{label}: first-step logits not finite")
    span = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(err <= LOGITS_REL_TOL * span,
          f"{label} first-step logits: kernel vs plain max_abs_err "
          f"{err:.4f} > {LOGITS_REL_TOL} * {span:.3f}")
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"{label} first step: logits {tuple(got.shape)} max_abs_err "
          f"{err:.4f} (logit range {span:.3f}, tol "
          f"{LOGITS_REL_TOL * span:.4f}), argmax agreement {agree:.3f}",
          flush=True)

    # warm-up off the clock: first launches of every op at both widths
    warm = DecodeEngine(model, scfg, generation=gen)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run()
    del warm

    def drive(serving, requests, max_new, run, per_step=None):
        """``per_step``: the gmm, qdot and gmm_quant launches each engine
        step must make (default: the bf16 model's, no quantized
        products)."""
        per_step = per_step or dict(gmm=routed, qdot=0, gmm_quant=0)
        eng = DecodeEngine(model, serving, generation=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pak.launches = 0                  # counts zeroed just before the run
        tpa.long_q_gather_calls = 0
        gk.gmm_launches = 0
        qk.qdot_launches = gq.gmm_quant_launches = 0
        t0 = time.perf_counter()
        for p in requests:
            eng.submit(p, max_new_tokens=max_new)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, gathers, gmms = (pak.launches, tpa.long_q_gather_calls,
                                   gk.gmm_launches)
        qdots, gquants = qk.qdot_launches, gq.gmm_quant_launches
        st = eng.stats()
        states = {r.state for r in eng.requests.values()}
        check(states == {RequestState.FINISHED},
              f"{run}: not every request finished: {st['outcomes']}")
        check(st["kernel_launches"] == launches,
              f"{run}: engine counted {st['kernel_launches']} launches, "
              f"the wrapper {launches}")
        check(launches == L * st["steps"],
              f"{run}: {launches} kernel launches != {L} layers x "
              f"{st['steps']} steps")
        check(gmms == per_step["gmm"] * st["steps"] == eng.gmm_launches,
              f"{run}: {gmms} gmm launches (engine {eng.gmm_launches}) != "
              f"{per_step['gmm']} x {st['steps']} steps")
        for kind, got in (("qdot", qdots), ("gmm_quant", gquants)):
            check(got == per_step[kind] * st["steps"],
                  f"{run}: {got} {kind} launches != {per_step[kind]} x "
                  f"{st['steps']} steps")
        check(gathers == 0, f"{run}: {gathers} long-query gather calls")
        check(bool(torch.isfinite(eng.last_logits).all()),
              f"{run}: non-finite logits")
        report = dict(
            run=run, requests=len(requests), max_new_tokens=max_new,
            decode_tok_s=st["tokens_generated"] / wall, wall_s=wall,
            steps=st["steps"], decode_steps=st["decode_steps"],
            mixed_steps=st["mixed_steps"], kernel_launches=launches,
            launches_per_step=launches / st["steps"], gmm_launches=gmms,
            qdot_launches=qdots, gmm_quant_launches=gquants,
            tokens_generated=st["tokens_generated"],
            preemptions=st["preemptions"], kv_pool_bytes=st["kv_pool_bytes"],
            weight_bytes=weight_bytes,
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        print("engine_run " + json.dumps(report), flush=True)
        return report

    main = drive(scfg, prompts, gen.max_new_tokens,
                 "bf16_kv" if label == "engine" else label)
    main["first_step"] = dict(max_abs_err=err, logit_range=span,
                              argmax_agreement=agree)
    if not moe:
        int8 = build_serving_config(
            {**cfg.serving.to_dict(), "kv_cache_dtype": "int8"})
        drive(int8, prompts[:8], 32, "int8_kv")
    # quantized compute with the paged cache: float8 tensorwise on every
    # eligible projection (and the experts), against the bf16 model on the
    # same requests
    if label == "engine" or moe:
        main["fp8"] = fp8_serving_leg(model, scfg, gen, prompts, drive,
                                      f"{label}_fp8" if moe
                                      else "serve_fp8", routed)
    if label == "engine":
        main["int8_base"] = int8_base_leg(L)
        main["fleet"] = fleet_phase(model)

    # where a step's time goes: a profiled window of prefill-carrying
    # steps, then one of pure decode steps, on a fresh engine
    eng = DecodeEngine(model, scfg, generation=gen)
    for p in prompts[:8]:
        eng.submit(p)

    def steps(n):
        return lambda: [eng.step() for _ in range(n)]

    tag = "" if label == "engine" else f"{label}_"
    main["profile_mixed"] = profile_window(steps(4 if moe else 6),
                                           4 if moe else 6,
                                           f"{tag}mixed_w32",
                                           ("paged_decode",))
    while any(len(r.pending) > 1 for r in eng.scheduler.active):
        eng.step()
    main["profile_decode"] = profile_window(steps(8 if moe else 10),
                                            8 if moe else 10,
                                            f"{tag}decode_w1",
                                            ("paged_decode",))
    eng.run()
    del eng
    if moe:
        torch.cuda.empty_cache()
        main["prefix"] = prefix_leg(model, f"{label}_prefix", ("bf16",),
                                    fork_run=False)
        main["gmm_cases"] = gmm_rows
        main["gmm_quant_cases"] = gmm_quant_rows
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# quantized serving and the fleet (legs of the engine phase)
# ---------------------------------------------------------------------------
FP8_REQUESTS, FP8_NEW = 8, 32
INT8_BASE_REQUESTS, INT8_BASE_NEW = 8, 32
# the fleet drill: 16 requests, prompts below 512 tokens (max_model_len
# 544 less the 32 new), the loss at the 20th health poll (one a step:
# mid-decode for every request admitted by then)
FLEET_REQUESTS, FLEET_NEW, FLEET_MAX_LEN, FLEET_LOSS_AT = 16, 32, 544, 20
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")


def quantized_projections(model):
    """Projections per forward that ``maybe_qdot`` quantizes: each layer's
    dense ``*_proj`` (the experts excluded) whose in and out widths are
    multiples of 16 and that no ``filter_fqns`` entry names."""
    from torch import nn

    n = 0
    for layer in model.layers:
        for name in PROJECTIONS:
            lin = getattr(layer, name, None)
            if (isinstance(lin, nn.Linear) and lin.in_features % 16 == 0
                    and lin.out_features % 16 == 0):
                n += 1
    return n


def decode_window(make, reqs, label, steps=8, max_new=64):
    """A profiled window (``profile_window``) of ``steps`` pure-decode
    steps of ``make()`` (an engine or a fleet) serving ``reqs``, after
    their prefills; the rest then runs off the profile."""
    eng = make()
    for p in reqs:
        eng.submit(p, max_new_tokens=max_new)

    def engines():
        return [r.engine for r in eng.replicas] if hasattr(
            eng, "replicas") else [eng]

    eng.step()
    while any(e.scheduler.waiting or any(len(r.pending) > 1
                                         for r in e.scheduler.active)
              for e in engines()):
        eng.step()
    report = profile_window(lambda: [eng.step() for _ in range(steps)],
                            steps, label, ("paged_decode",))
    eng.run()
    return report


def fp8_serving_leg(model, scfg, gen, prompts, drive, label, routed):
    """``apply_fp8_to_model`` (float8 tensorwise) on the engine's model: the
    first step's logits through every kernel (paged decode, qdot,
    gmm_quant) against every plain version, their largest difference
    within the larger of 5 % of the logit range and
    ``QUANT_GRAD_FLOOR_FACTOR`` times the run's floor (every kernel against
    every kernel but the attention's plain version: two equally right
    computations, whose bf16 ulps flip e4m3 codes at rounding midpoints,
    and the flips compound over the layers); then ``FP8_REQUESTS``
    requests of ``FP8_NEW`` tokens with the counts zeroed just before and
    read just after -- qdot once per quantized projection and step,
    gmm_quant 3 times per routed layer and step, the bf16 gmm never --
    beside the bf16 model on the same requests."""
    import torch

    from automodel_tpu_torch.quantization import fp8
    from automodel_tpu_torch.serving import DecodeEngine

    moe = hasattr(model, "gmm_impl")
    reqs = prompts[:FP8_REQUESTS]
    bf16 = drive(scfg, reqs, FP8_NEW, f"{label}_bf16_reference")
    fp8.apply_fp8_to_model(model, fp8.FP8Config(enabled=True,
                                                dtype="float8"))
    try:
        n_q = quantized_projections(model)
        firsts = {}
        # (route, attention, quantized products)
        for route, attn, prod in (("plain", "plain", "plain"),
                                  ("kernel", "kernel", "kernel"),
                                  ("attn_plain", "plain", "kernel")):
            model.qdot_impl = prod
            if moe:
                model.gmm_impl = prod
            eng = DecodeEngine(model, scfg, generation=gen, attn_impl=attn)
            for p in reqs:
                eng.submit(p, max_new_tokens=FP8_NEW)
            eng.step()
            firsts[route] = eng.last_logits.clone()
            del eng
        model.qdot_impl = None
        if moe:
            model.gmm_impl = None
        torch.cuda.empty_cache()
        ref, got = firsts["plain"], firsts["kernel"]
        check(bool(torch.isfinite(got).all()),
              f"{label}: first-step logits not finite")
        span = float(ref.abs().max())
        err = float((got - ref).abs().max())
        floor = float((got - firsts["attn_plain"]).abs().max())
        limit = max(LOGITS_REL_TOL * span, QUANT_GRAD_FLOOR_FACTOR * floor)
        check(err <= limit,
              f"{label} first-step logits: kernels vs plain max_abs_err "
              f"{err:.4f} > {limit:.4f} (the larger of {LOGITS_REL_TOL} x "
              f"range {span:.3f} and {QUANT_GRAD_FLOOR_FACTOR} x floor "
              f"{floor:.4f})")
        warm = DecodeEngine(model, scfg, generation=gen)
        warm.submit(reqs[0][:40], max_new_tokens=4)
        warm.run()
        del warm
        run = drive(scfg, reqs, FP8_NEW, label,
                    per_step=dict(gmm=0, qdot=n_q, gmm_quant=routed))
        run["profile_decode"] = decode_window(
            lambda: DecodeEngine(model, scfg, generation=gen), reqs,
            f"{label}_decode_w1")
    finally:
        model.quant = None
        model.qdot_impl = None
        if moe:
            model.gmm_impl = None
    report = dict(
        recipe="float8 tensorwise", quantized_projections_per_step=n_q,
        gmm_quant_per_step=routed,
        first_step=dict(max_abs_err=err, logit_range=span,
                        rel_to_range=err / span, floor_max_abs_err=floor,
                        limit=limit, argmax_agreement=float(
                            (got.argmax(-1) == ref.argmax(-1)).float()
                            .mean()),
                        rel_l2=float((got - ref).norm() / ref.norm())),
        decode_tok_s=run["decode_tok_s"],
        bf16_decode_tok_s=bf16["decode_tok_s"],
        fp8_over_bf16=run["decode_tok_s"] / bf16["decode_tok_s"],
        run=run, bf16_run=bf16)
    print(f"{label} " + json.dumps(report), flush=True)
    return report


def _serve_yaml_copy(tag, edits):
    """The Llama-3.2-1B serve YAML with ``edits`` ((old line, new lines))
    applied, written to a fresh temporary directory; returns its path."""
    import tempfile

    with open(SERVE_YAML) as f:
        text = f.read()
    for old, new in edits:
        check(old in text, f"{tag}: {SERVE_YAML} lacks {old.strip()!r}")
        text = text.replace(old, new, 1)
    path = os.path.join(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"),
                        f"llama3_2_1b_serve_{tag}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _same_bits(a, b):
    """``a`` and ``b`` hold the same bytes (dtype and shape included)."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def _rows(eng, first_rid, n):
    """Generated tokens of requests ``first_rid .. first_rid + n - 1``."""
    return [list(eng.requests[first_rid + i].out_tokens) for i in range(n)]


def _partings(model, prompts, got, want):
    """Rows of ``got`` and ``want`` (greedy runs of the same prompts):
    how many are identical, and for each that parts the position, both
    tokens, and the gap between their logits (``want``'s less ``got``'s)
    in one dense forward of the prompt and the common prefix."""
    import torch

    parted = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(t for t in range(min(len(g), len(w))) if g[t] != w[t])
        ids = torch.tensor([prompts[i] + w[:j]], device="cuda")
        with torch.inference_mode():
            logits = model(ids)["logits"][0, -1].float()
        parted.append(dict(row=i, position=j, token=g[j], reference=w[j],
                           logit_gap=float(logits[w[j]] - logits[g[j]])))
    return dict(identical_rows=len(got) - len(parted), rows=len(got),
                parted=parted)


def int8_base_leg(L):
    """The serve YAML with ``model.weight_only_quant: int8`` added, through
    the port's ``tools/serve.py`` (its ``serve``, the body of ``main``):
    every request FINISHED, paged decode once per layer and step, the
    projections int8 codes; then the same int8 model through the plain
    attention: the first step's logits within 5 % of the logit range, and
    the same prompts served token for token, where a row may part only at
    a near-tie -- its two candidates' logits (one dense forward of the
    prompt and common prefix) closer than the first step's largest
    kernel-vs-plain difference, the run's own rounding floor (random
    weights give flat logits: bf16 rounding of the attention flips such
    ties); the projection weights' bytes against bf16."""
    import torch

    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.quantization.weight_only import (
        Int8Linear,
        is_quantized,
    )
    from automodel_tpu_torch.serving import DecodeEngine
    from automodel_tpu_torch.tools import serve as serve_tool

    anchor = "  _target_: automodel_tpu_torch.models.auto_model.build_model\n"
    path = _serve_yaml_copy("int8_base", [
        (anchor, anchor + "  weight_only_quant: int8\n")])
    torch.cuda.synchronize()
    pak.launches = 0                      # counts zeroed just before
    out = serve_tool.serve(["-c", path, "--requests",
                            str(INT8_BASE_REQUESTS), "--max-new",
                            str(INT8_BASE_NEW)])
    torch.cuda.synchronize()
    launches = pak.launches
    eng, prompts = out["engine"], out["prompts"]
    model = eng.model
    st = eng.stats()
    check(out["rc"] == 0, f"serve_int8_base: exit {out['rc']} "
          f"({st['outcomes']})")
    check(is_quantized(model), "serve_int8_base: the YAML built no int8 base")
    check(launches == L * st["steps"] == st["kernel_launches"],
          f"serve_int8_base: {launches} paged-decode launches != {L} "
          f"layers x {st['steps']} steps")
    q = [m for m in model.modules() if isinstance(m, Int8Linear)]
    int8_bytes = sum(m.weight.numel() + 4 * m.scale.numel() for m in q)
    bf16_bytes = sum(2 * m.weight.numel() for m in q)
    firsts = {}
    for impl in ("plain", "kernel"):
        first = DecodeEngine(model, eng.config, generation=eng.generation,
                             attn_impl=impl)
        for p in prompts:
            first.submit(p)
        first.step()
        firsts[impl] = first.last_logits.clone()
        del first
    span = float(firsts["plain"].abs().max())
    err = float((firsts["kernel"] - firsts["plain"]).abs().max())
    check(err <= LOGITS_REL_TOL * span,
          f"serve_int8_base first-step logits: kernel vs plain max_abs_err "
          f"{err:.4f} > {LOGITS_REL_TOL} * {span:.3f}")
    ref = DecodeEngine(model, eng.config, generation=eng.generation,
                       attn_impl="plain")
    ref.submit(prompts[0])                # the tool's warm-up request
    ref.run()
    for p in prompts:
        ref.submit(p, max_new_tokens=INT8_BASE_NEW)
    ref.run()
    rows = _partings(model, prompts, _rows(eng, 1, len(prompts)),
                     _rows(ref, 1, len(prompts)))
    profile = decode_window(
        lambda: DecodeEngine(model, eng.config, generation=eng.generation),
        prompts, "serve_int8_base_decode_w1")
    report = dict(
        requests=INT8_BASE_REQUESTS, new_tokens=INT8_BASE_NEW,
        decode_tok_s=out["report"]["decode_tok_s"],
        wall_s=out["report"]["wall_s"], steps=st["steps"],
        paged_decode_launches=launches, int8_projections=len(q),
        projection_bytes_int8=int8_bytes, projection_bytes_bf16=bf16_bytes,
        bytes_ratio=int8_bytes / bf16_bytes,
        weight_bytes=sum(t.numel() * t.element_size()
                         for t in model.state_dict().values()),
        first_step=dict(max_abs_err=err, logit_range=span,
                        tol=LOGITS_REL_TOL * span),
        plain_attention_tokens=rows, profile_decode=profile)
    print("serve_int8_base " + json.dumps(report), flush=True)
    wide = [r for r in rows["parted"] if abs(r["logit_gap"]) > err]
    check(not wide,
          f"serve_int8_base: kernel and plain attention part away from a "
          f"near-tie (|gap| > the first step's {err:.4f}): {wide}")
    del eng, ref, model, out
    torch.cuda.empty_cache()
    return report


def _fleet_drill(model, loss_at, label):
    """One run of the port's serve tool in fleet mode (``--replicas 2
    --router-policy least_loaded --drill-loss-at loss_at``) on ``model``,
    the counts zeroed just before and read just after, with the fleet's
    gates; returns ``(fleet, prompts, report)``."""
    import torch

    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.tools import serve as serve_tool

    path = _serve_yaml_copy("fleet", [
        ("  max_model_len: 2048\n",
         f"  max_model_len: {FLEET_MAX_LEN}\n")])
    L = model.config.num_hidden_layers
    torch.cuda.synchronize()
    pak.launches = 0
    out = serve_tool.serve(
        ["-c", path, "--requests", str(FLEET_REQUESTS), "--max-new",
         str(FLEET_NEW), "--replicas", "2", "--router-policy",
         "least_loaded", "--drill-loss-at", str(loss_at)], model=model)
    torch.cuda.synchronize()
    launches = pak.launches
    fleet, rep = out["engine"], out["report"]
    check(out["rc"] == 0, f"{label}: exit {out['rc']} ({rep['outcomes']})")
    check(rep["replica_losses"] == 1 and rep["readmissions"] == 1,
          f"{label}: {rep['replica_losses']} losses, {rep['readmissions']} "
          "readmissions (1 and 1 drilled)")
    check(fleet.all_free(), f"{label}: an allocator is not all free")
    per = rep["per_replica"]
    steps = sum(r["steps"] + r["retired_steps"] for r in per.values())
    counted = sum(r["kernel_launches"] + r["retired_kernel_launches"]
                  for r in per.values())
    check(launches == counted == L * steps,
          f"{label}: {launches} paged-decode launches (replicas counted "
          f"{counted}) != {L} layers x {steps} steps")
    check(all(r["watchdog_recoveries"] == 0 for r in per.values()),
          f"{label}: a watchdog recovery nobody armed")
    peer = fleet.replicas[0].engine.model.state_dict()
    new = fleet.replicas[1].engine.model.state_dict()
    check(fleet.replicas[1].engine.model is not model
          and set(peer) == set(new)
          and all(_same_bits(peer[k], new[k]) for k in peer),
          f"{label}: the admitted replica's weights are not its peer's bit "
          "for bit")
    rep = dict(rep, paged_decode_launches=launches, steps_all=steps)
    return fleet, out["prompts"], rep


def _single_engine(model, fleet, prompts):
    """One uninterrupted engine over ``prompts`` (submitted in order after
    the tool's warm-up request); ``(engine, wall s)``."""
    import torch

    from automodel_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(model, fleet.config, generation=fleet.generation)
    eng.submit(prompts[0])
    eng.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p)
    eng.run()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def fleet_phase(model):
    """The elastic fleet through the port's serve tool on the engine
    phase's Llama-3.2-1B (16 layers, the replicas sharing its weights):
    ``--replicas 2 --router-policy least_loaded --drill-loss-at 20`` over
    16 requests of 4-511 prompt tokens and 32 new each: exit 0, one loss
    with its replays, one readmission after probation whose engine's
    weights equal its peer's bit for bit, every allocator free, paged
    decode once per layer and step summed over the replicas (retired
    engines included); then its rows against one uninterrupted engine
    (identical rows reported; where a row parts, the token and the logit
    gap there), and the fleet's tok/s against that engine's.  Second, the
    loss at the first poll, before any token is sampled: the survivor
    serves every request and its tokens equal one engine's fed the same
    order, row for row."""
    import torch

    from automodel_tpu_torch.serving import FleetRouter

    n = FLEET_REQUESTS
    fleet, prompts, rep = _fleet_drill(model, FLEET_LOSS_AT, "serve_fleet")
    check(rep["replays"] >= 1, f"serve_fleet: {rep['replays']} replays")
    n_warm = len(fleet.replicas)          # one warm-up request a replica
    got = [list(fleet.requests[n_warm + i].out_tokens) for i in range(n)]
    single, wall = _single_engine(model, fleet, prompts)
    mid = _partings(model, prompts, got, _rows(single, 1, n))
    single_tok_s = n * FLEET_NEW / wall
    fleet.teardown()
    # a fleet step: both replicas' engine steps, 8 decode rows each
    profile = decode_window(
        lambda: FleetRouter(model, fleet.config, generation=fleet.generation),
        prompts, "serve_fleet_decode_w1", max_new=FLEET_NEW)
    del fleet, single
    torch.cuda.empty_cache()

    fleet2, prompts2, rep2 = _fleet_drill(model, 1, "serve_fleet_early")
    check(rep2["replays"] == 0,
          f"serve_fleet_early: {rep2['replays']} replays of requests lost "
          "before any step")
    survivor = fleet2.replicas[0].engine
    order = sorted((r for r in survivor.requests.values()
                    if r.rid >= n_warm), key=lambda r: r.arrival)
    check(len(order) == n, f"serve_fleet_early: the survivor served "
          f"{len(order)} of {n} requests")
    single2, _ = _single_engine(model, fleet2, [r.prompt for r in order])
    early = _partings(model, [r.prompt for r in order],
                      [list(r.out_tokens) for r in order],
                      _rows(single2, 1, n))
    fleet2.teardown()
    report = dict(
        requests=n, new_tokens=FLEET_NEW, loss_at_poll=FLEET_LOSS_AT,
        decode_tok_s=rep["decode_tok_s"], single_engine_tok_s=single_tok_s,
        fleet_over_single=rep["decode_tok_s"] / single_tok_s,
        wall_s=rep["wall_s"], replica_losses=rep["replica_losses"],
        replays=rep["replays"], readmissions=rep["readmissions"],
        fleet_rejected=rep["fleet_rejected"],
        health_polls=rep["health_polls"], routed=rep["routed"],
        paged_decode_launches=rep["paged_decode_launches"],
        steps=rep["steps_all"], weight_bytes=rep["weight_bytes"],
        per_replica=rep["per_replica"], mid_decode=mid,
        profile_decode=profile,
        early=dict(paged_decode_launches=rep2["paged_decode_launches"],
                   steps=rep2["steps_all"], readmissions=rep2["readmissions"],
                   tokens=early))
    print("serve_fleet " + json.dumps(report), flush=True)
    check(early["identical_rows"] == n,
          f"serve_fleet_early: the survivor's rows part from one engine's: "
          f"{early['parted']}")
    del fleet2, single2, survivor, order
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# serving features phase
# ---------------------------------------------------------------------------
SERVE_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                          "llama3_2_1b_serve.yaml")
# projections a LoRA adapter reaches in every layer (``*_proj``)
ADAPTED_PROJECTIONS = 7


def _serve_base():
    from automodel_tpu_torch.config.loader import load_yaml_config

    cfg = load_yaml_config(SERVE_YAML)
    return cfg, cfg.serving.to_dict()


def feature_run(model, label, serving, requests, max_new, *, load=None,
                adapted=0, fault=None, batches=None):
    """One timed run of the port's engine: a fresh engine (the serve YAML's
    ``serving:`` with ``serving`` overrides), ``load(engine)`` (adapters),
    a warm-up request off the clock, then ``requests`` ((prompt, adapter
    id) pairs) submitted at once and run to the end -- or each list of
    ``batches`` in turn -- the kernel counts zeroed just before and read
    just after: paged decode once per layer and step, gmm twice per
    adapted projection, layer and step (``adapted`` projections), no
    long-query gather.  ``fault`` arms a fault spec for the timed run.
    Returns ``(report, tokens per request, engine)``."""
    import torch

    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        RequestState,
        build_serving_config,
    )
    from automodel_tpu_torch.utils import fault_injection as fi

    _, base = _serve_base()
    eng = DecodeEngine(model, build_serving_config({**base, **serving}),
                       generation=GenerationConfig(max_new_tokens=max_new))
    if load is not None:
        load(eng)
    # the warm-up's prefill commits its prompt's blocks (prefix cache on)
    first = (batches or [requests])[0][0]
    eng.submit(first[0], adapter_id=first[1], max_new_tokens=4)
    eng.run()
    steps0, tok0 = eng.steps_run, eng.tokens_generated
    L = model.config.num_hidden_layers
    fi.configure_faults(fault)
    torch.cuda.synchronize()
    pak.launches = 0                      # counts zeroed just before the run
    tpa.long_q_gather_calls = 0
    gk.gmm_launches = 0
    t0 = time.perf_counter()
    rids = []
    for batch in batches or [requests]:
        rids += [eng.submit(p, adapter_id=a) for p, a in batch]
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gathers, gmms = (pak.launches, tpa.long_q_gather_calls,
                               gk.gmm_launches)
    fi.reset_faults()
    st = eng.stats()
    steps = eng.steps_run - steps0
    states = {eng.requests[r].state for r in rids}
    check(states == {RequestState.FINISHED},
          f"{label}: not every request finished: {st['outcomes']}")
    check(launches == L * steps,
          f"{label}: {launches} paged-decode launches != {L} layers x "
          f"{steps} steps")
    check(gathers == 0, f"{label}: {gathers} long-query gather calls")
    # an MoE model's routed experts: 3 gmm launches a routed layer and step
    routed = 3 * moe_layer_count(model) if hasattr(model, "gmm_impl") else 0
    check(gmms == (2 * adapted * L + routed) * steps,
          f"{label}: {gmms} gmm launches != (2 x {adapted} projections x {L}"
          f" layers + {routed} routed) x {steps} steps")
    check(eng.allocator.all_free, f"{label}: KV blocks leaked")
    check(bool(torch.isfinite(eng.last_logits).all()),
          f"{label}: non-finite logits")
    report = dict(
        run=label, requests=len(rids), max_new_tokens=max_new,
        tok_s=(eng.tokens_generated - tok0) / wall, wall_s=wall, steps=steps,
        tokens_per_step=(eng.tokens_generated - tok0) / max(1, steps),
        paged_decode_launches=launches, gmm_launches=gmms,
        step_widths=st["step_widths"], preemptions=st["preemptions"],
        watchdog_recoveries=st["watchdog_recoveries"])
    return report, [list(eng.requests[r].out_tokens) for r in rids], eng


def _identical(label, a, b):
    """Token identity of two runs, with where they first part if not."""
    if a == b:
        return
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            j = next(k for k, (p, q) in enumerate(zip(x, y)) if p != q)
            fail(f"{label}: request {i} parts at token {j}: {x[:j + 2]} vs "
                 f"{y[:j + 2]}")
    fail(f"{label}: the runs return different requests")


def prefix_leg(model, label="serving_features_prefix",
               kvs=("bf16", "int8"), fork_run=True):
    """bench.py's prefix-cache leg: 16 requests of a shared 96-token prefix
    (six full blocks) plus a 4-token tail, 16 new tokens, 8 slots, cache
    on and off (each KV dtype of ``kvs``); then (``fork_run``) 8 identical
    96-token prompts, whose fully cached chains fork their last block
    copy-on-write.  Prints the ``label`` line."""
    import numpy as np

    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, 2000, 96)]
    reqs = [(shared + [int(t) for t in rng.integers(1, 2000, 4)], 0)
            for _ in range(16)]
    forks = [(list(shared), 0)] * 8
    out = {}
    for kv in kvs:
        base = dict(max_num_seqs=8, max_model_len=128,
                    kv_cache_dtype="int8" if kv == "int8" else None)
        runs = {}
        for mode in ("off", "on"):
            runs[mode] = feature_run(model, f"prefix_{kv}_{mode}",
                                     {**base, "prefix_caching": mode},
                                     reqs, 16)
        _identical(f"prefix cache {kv}: on vs off", runs["on"][1],
                   runs["off"][1])
        eng = runs["on"][2]
        st = eng.stats()
        check(st["prefill_tokens_saved"] == 16 * 96,
              f"prefix {kv}: {st['prefill_tokens_saved']} prompt tokens "
              f"reused, expected {16 * 96}")
        out[kv] = dict(
            off_tok_s=runs["off"][0]["tok_s"], on_tok_s=runs["on"][0]["tok_s"],
            on_vs_off=runs["on"][0]["tok_s"] / runs["off"][0]["tok_s"],
            prefill_tokens_saved=st["prefill_tokens_saved"],
            cache_hit_rate=st["cache_hit_rate"],
            cow_forks=st["prefix_cache"]["cow_forks"],
            off=runs["off"][0], on=runs["on"][0])
    if not fork_run:
        print(f"{label} " + json.dumps(out), flush=True)
        return out
    fork = {m: feature_run(model, f"prefix_fork_{m}",
                           dict(max_num_seqs=8, max_model_len=128,
                                prefix_caching=m), forks, 16)
            for m in ("off", "on")}
    _identical("prefix cache fork: on vs off", fork["on"][1], fork["off"][1])
    st = fork["on"][2].stats()
    check(st["prefix_cache"]["cow_forks"] >= 8,
          f"prefix fork: {st['prefix_cache']['cow_forks']} COW forks < 8")
    out["fork"] = dict(cow_forks=st["prefix_cache"]["cow_forks"],
                       deferrals=st["prefix_cache"]["deferrals"],
                       prefill_tokens_saved=st["prefill_tokens_saved"],
                       on=fork["on"][0], off=fork["off"][0])
    print(f"{label} " + json.dumps(out), flush=True)
    return out


def speculative_leg(model):
    """bench.py's speculative leg: 16 periodic-motif prompts and 16
    all-distinct ones of 24 tokens, 48 new tokens, spec_k 4, on and off.
    The weights are random: acceptance is what such a model gives."""
    import numpy as np

    rng = np.random.default_rng(0)
    motif = [int(t) for t in rng.integers(1, 2000, 6)]
    rep = [((motif * 5)[:24], 0) for _ in range(16)]
    adv = [([int(t) for t in rng.permutation(np.arange(1, 2000))[:24]], 0)
           for _ in range(16)]
    out = {}
    for name, reqs in (("periodic", rep), ("distinct", adv)):
        base = dict(max_num_seqs=8, max_model_len=72)
        off = feature_run(model, f"spec_{name}_off", base, reqs, 48)
        on = feature_run(model, f"spec_{name}_on",
                         {**base, "speculative": "ngram", "spec_k": 4},
                         reqs, 48)
        _identical(f"speculative {name}: on vs off", on[1], off[1])
        st = on[2].stats()
        out[name] = dict(off_tok_s=off[0]["tok_s"], on_tok_s=on[0]["tok_s"],
                         on_vs_off=on[0]["tok_s"] / off[0]["tok_s"],
                         accept_rate=st["accept_rate"],
                         tokens_per_step=on[0]["tokens_per_step"],
                         off_tokens_per_step=off[0]["tokens_per_step"],
                         tokens_proposed=st["speculative"]["tokens_proposed"],
                         note="random weights: acceptance is what such a "
                              "model gives",
                         on=on[0], off=off[0])
    print("serving_features_speculative " + json.dumps(out), flush=True)
    return out


def _adapter_tree(model, seed):
    """A synthetic rank-8 adapter on every ``*_proj`` (JAX layout, the
    serve tool's), big enough to move the logits well past the check's
    tolerance."""
    import numpy as np

    from automodel_tpu_torch.tools.serve import synthetic_adapters

    return synthetic_adapters(model, LORA_RANK, np.random.default_rng(seed),
                              scale=0.02)


def multi_lora_leg(model):
    """bench.py's multi-LoRA leg: rank-8 adapters on every ``*_proj``,
    n in {1, 4, 16} slots, 32 requests of 24 tokens, 16 new tokens, mixed
    (ids round-robin over the slots) and serial (one tenant at a time)
    against a base-only engine; then the mixed batch's first-step logits
    against merged single-adapter engines (a LoRAModel over the same
    base), within the engine phase's tolerance."""
    import numpy as np
    import torch

    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.peft.lora import LoRAModel, PeftConfig
    from automodel_tpu_torch.serving import DecodeEngine, build_serving_config

    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 2000, 24)]
               for _ in range(32)]
    trees = {slot: _adapter_tree(model, 100 + slot) for slot in range(1, 17)}
    alpha_over_r = 2.0
    base = dict(max_num_seqs=8, max_model_len=40)
    plain = feature_run(model, "lora_base_only", base,
                        [(p, 0) for p in prompts], 16)
    out = {"base_tok_s": plain[0]["tok_s"]}

    def loader(n):
        def load(eng):
            for slot in range(1, n + 1):
                eng.load_adapter(slot, trees[slot], scale=alpha_over_r)
        return load

    for n in (1, 4, 16):
        mt = {**base, "max_adapters": n, "adapter_rank": LORA_RANK}
        ids = [1 + i % n for i in range(len(prompts))]
        mixed = feature_run(model, f"lora_n{n}_mixed", mt,
                            list(zip(prompts, ids)), 16, load=loader(n),
                            adapted=ADAPTED_PROJECTIONS)
        serial = feature_run(
            model, f"lora_n{n}_serial", mt, None, 16, load=loader(n),
            adapted=ADAPTED_PROJECTIONS,
            batches=[[(p, a) for p, a in zip(prompts, ids) if a == t]
                     for t in range(1, n + 1)])
        out[f"n{n}"] = dict(
            mixed_tok_s=mixed[0]["tok_s"], serial_tok_s=serial[0]["tok_s"],
            mixed_vs_serial=mixed[0]["tok_s"] / serial[0]["tok_s"],
            mixed_vs_base=mixed[0]["tok_s"] / plain[0]["tok_s"],
            gmm_launches=mixed[0]["gmm_launches"], steps=mixed[0]["steps"],
            mixed=mixed[0])

    # where a mixed multi-tenant decode step's time goes (n = 4), beside
    # the engine phase's base-only decode_w1 window
    gen16 = GenerationConfig(max_new_tokens=16)
    eng = DecodeEngine(model, build_serving_config(
        {**_serve_base()[1], **base, "max_adapters": 4,
         "adapter_rank": LORA_RANK}), generation=gen16)
    loader(4)(eng)
    for i, p in enumerate(prompts[:8]):
        eng.submit(p, adapter_id=i % 5)
    eng.step()
    while any(len(r.pending) > 1 for r in eng.scheduler.active):
        eng.step()
    out["profile_n4_decode"] = profile_window(
        lambda: [eng.step() for _ in range(10)], 10, "lora_n4_decode_w1",
        ("paged_decode",))
    eng.run()
    del eng

    # first step of a mixed batch (tenants 1..4 and base) against each
    # tenant's rows through a merged single-adapter engine, and against the
    # base model (how far the adapters move the logits)
    gen = GenerationConfig(max_new_tokens=4)
    scfg = build_serving_config({**_serve_base()[1], **base,
                                 "max_adapters": 4,
                                 "adapter_rank": LORA_RANK})
    ids = [1, 2, 3, 4, 0, 1, 2, 3]

    plain_scfg = build_serving_config({**_serve_base()[1], **base})

    def first_logits(served, rows, serving=None, load=None):
        """The first step's last-token logits of ``rows`` (their slots in
        submission order) through a fresh engine over ``served``."""
        eng = DecodeEngine(served, serving or plain_scfg, generation=gen)
        if load is not None:
            load(eng)
        for b in rows:
            eng.submit(prompts[b], adapter_id=ids[b] if load else 0)
        eng.step()
        return {b: eng.last_logits[i].clone() for i, b in enumerate(rows)}

    mixed_logits = first_logits(model, range(8), serving=scfg,
                                load=loader(4))
    base_logits = first_logits(model, range(8))
    errs, effects = [0.0] * 8, []
    for a in range(5):
        rows = [b for b in range(8) if ids[b] == a]
        served = model
        if a:
            served = LoRAModel(model, PeftConfig(dim=LORA_RANK,
                                                 alpha=2 * LORA_RANK))
            served.load_adapter_tree(trees[a])
        ref = first_logits(served, rows)
        for b in rows:
            span = float(ref[b].abs().max())
            errs[b] = float((mixed_logits[b] - ref[b]).abs().max()) / span
            if a:
                effects.append(float((base_logits[b] - ref[b]).abs().max())
                               / span)
        del served
        torch.cuda.empty_cache()
    check(max(errs) <= LOGITS_REL_TOL,
          f"multi-LoRA first step: mixed vs merged max_abs_err / range "
          f"{max(errs):.4f} > {LOGITS_REL_TOL}")
    check(min(effects) > 2 * LOGITS_REL_TOL,
          f"multi-LoRA first step: the adapters move the logits by only "
          f"{min(effects):.4f} of the range: the check cannot see them")
    out["first_step"] = dict(rel_err_max=max(errs), rel_err=errs,
                             adapter_effect_min=min(effects),
                             tol=LOGITS_REL_TOL)
    print("serving_features_multi_lora " + json.dumps(out), flush=True)
    return out


def _trace(eng, prompts, arrivals, deadline_s=None, max_queue_s=None):
    """Step ``eng`` through a host-drawn arrival trace (bench.py's
    ``_drive_arrival_trace``); returns (wall_s, completed latencies)."""
    lat, rids, submitted = {}, {}, 0
    t0 = time.perf_counter()
    while submitted < len(prompts) or eng.scheduler.has_work():
        now = time.perf_counter() - t0
        while submitted < len(prompts) and arrivals[submitted] <= now:
            rids[eng.submit(prompts[submitted], deadline_s=deadline_s,
                            max_queue_s=max_queue_s)] = submitted
            submitted += 1
        for req in eng.step():
            if req.rid in rids:
                lat[req.rid] = (time.perf_counter() - t0
                                - arrivals[rids[req.rid]])
        if not eng.scheduler.has_work() and submitted < len(prompts):
            time.sleep(max(0.0, min(0.001, arrivals[submitted]
                                    - (time.perf_counter() - t0))))
    return time.perf_counter() - t0, lat


def serve_trace_leg(model):
    """bench.py's serve-trace leg: a seeded Poisson trace of 32 requests
    (8-32 prompt tokens, 24 new, 8 slots), then a second pass at twice the
    measured rate with deadlines (4 unloaded request times), queue TTLs,
    ``max_waiting`` 8, ``by_deadline`` shedding and ``max_preemptions`` 2;
    the kernel counts zeroed just before each pass and read just after.
    Then one armed ``serve_watchdog_stall`` recovery (the stall at the
    second step, prompts of 40-60 tokens) against an unarmed run."""
    import numpy as np
    import torch

    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.serving import DecodeEngine, build_serving_config
    from automodel_tpu_torch.training.timers import (
        serve_expired_rate,
        serve_goodput_fraction,
        serve_shed_rate,
    )

    L = model.config.num_hidden_layers
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 2000, int(n))]
               for n in rng.integers(8, 33, 32)]
    gen = GenerationConfig(max_new_tokens=24)
    base = {**_serve_base()[1], "max_num_seqs": 8, "max_model_len": 56}
    eng = DecodeEngine(model, build_serving_config(base), generation=gen)
    eng.submit(prompts[0])
    eng.run()
    probe0 = time.perf_counter()
    eng.submit(prompts[0])
    eng.run()
    per_req = time.perf_counter() - probe0
    arrivals = np.cumsum(rng.exponential(per_req / 2, size=len(prompts)))

    def counted(run, e):
        s0 = e.steps_run
        torch.cuda.synchronize()
        pak.launches = 0
        tpa.long_q_gather_calls = 0
        wall, lat = run()
        torch.cuda.synchronize()
        steps = e.steps_run - s0
        check(pak.launches == L * steps,
              f"serve_trace: {pak.launches} launches != {L} x {steps} steps")
        check(tpa.long_q_gather_calls == 0, "serve_trace: gather calls")
        check(e.allocator.all_free, "serve_trace: KV blocks leaked")
        return wall, lat, steps

    wall, lat, steps = counted(lambda: _trace(eng, prompts, arrivals), eng)
    ms = np.asarray(sorted(lat.values())) * 1e3
    rate = len(prompts) / wall
    over = DecodeEngine(model, build_serving_config(
        {**base, "max_waiting": 8, "shed_policy": "by_deadline",
         "max_preemptions": 2}), generation=gen)
    over.submit(prompts[0])
    over.run()
    arrivals2 = np.cumsum(rng.exponential(1.0 / (2.0 * rate),
                                          size=len(prompts)))
    deadline = max(4.0 * per_req, 0.05)
    wall2, lat2, steps2 = counted(lambda: _trace(
        over, prompts, arrivals2, deadline_s=deadline,
        max_queue_s=deadline / 2), over)
    outcomes = over.outcome_counts()
    outcomes["finished"] = outcomes.get("finished", 1) - 1   # the warm-up
    ms2 = np.asarray(sorted(lat2.values())) * 1e3
    check(sum(outcomes.values()) == len(prompts),
          f"serve_trace overload: outcomes {outcomes}")

    # the watchdog drill: stall at the second step, before any token was
    # sampled, so the replay recomputes exactly what the stall dropped
    long = [([int(t) for t in rng.integers(1, 2000, int(n))], 0)
            for n in rng.integers(40, 61, 8)]
    armed = feature_run(model, "watchdog_armed", dict(watchdog_s=30.0),
                        long, 16, fault="serve_watchdog_stall:2")
    clean = feature_run(model, "watchdog_unarmed", dict(watchdog_s=30.0),
                        long, 16)
    check(armed[0]["watchdog_recoveries"] == 1,
          f"watchdog: {armed[0]['watchdog_recoveries']} recoveries")
    _identical("watchdog recovery: armed vs unarmed", armed[1], clean[1])
    out = dict(
        requests=len(prompts), requests_s=rate, wall_s=wall, steps=steps,
        p50_ms=float(np.percentile(ms, 50)),
        p99_ms=float(np.percentile(ms, 99)),
        overload=dict(
            requests_s=len(prompts) / wall2, steps=steps2,
            deadline_s=deadline, outcomes=outcomes,
            shed_rate=serve_shed_rate(outcomes),
            expired_rate=serve_expired_rate(outcomes),
            goodput_fraction=serve_goodput_fraction(
                over.completed_in_deadline() - 1, outcomes),
            p50_ms=float(np.percentile(ms2, 50)) if len(ms2) else None,
            p99_ms=float(np.percentile(ms2, 99)) if len(ms2) else None,
            preemptions=over.stats()["preemptions"],
            pinned=over.stats()["pinned"]),
        watchdog=dict(recoveries=armed[0]["watchdog_recoveries"],
                      armed=armed[0], unarmed=clean[0]))
    print("serving_features_serve_trace " + json.dumps(out), flush=True)
    return out


def serving_features_phase():
    """Llama-3.2-1B at full width and 16 layers (the serve YAML, weights
    from seed 0) through the port's serving features: prefix caching,
    speculation, multi-tenant LoRA and a served trace with deadlines,
    shedding and a watchdog recovery."""
    import torch

    cfg, _ = _serve_base()
    model = cfg.model.instantiate(seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {}
    for name, leg in (("prefix_cache", prefix_leg),
                      ("speculative", speculative_leg),
                      ("multi_lora", multi_lora_leg),
                      ("serve_trace", serve_trace_leg)):
        out[name] = leg(model)
        phase_done(f"serving_features {name}")
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve_moe phase: Qwen3-30B-A3B through the decode engine
# ---------------------------------------------------------------------------
MOE_SERVE_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                              "qwen3_30b_a3b_serve.yaml")
# serve_moe's depth and sft_gemma3_4b_cord's (GEMMA3_4B_LAYERS): the
# script must end within 1200 s; uncut it ran 1201.8 s on one H100 (a
# call whose host ran every phase 20-50 % slower than the call before;
# serve_moe 154.4 s of it at 48 layers, sft_gemma3_4b_cord 217.1 s at 34),
# so both ran about half their stack, and since the pretraining,
# classifier and family phases joined (~190 s more) a quarter: 12 of 48
# layers, 6 of 34 (one block of Gemma-3's 5 sliding and 1 full layer),
# every shape and kernel kept
MOE_SERVE_LAYERS = 12
# the engine's routed grouped matmuls: a decode step (8 slots x 1 token x
# top-8 = 64 assignments over 128 experts) and a prefill-chunk step (8 x
# 32 tokens = 2048 assignments), each segment block-padded to 128 rows as
# sorted_expert_ffn lays them out
SERVE_GMM_CASES = (("serve_decode_m64", 8), ("serve_prefill_m2048", 256))


def seeded_routing_sizes(tokens, E, k, seed):
    """``(padded sizes [E], n_pad)`` of ``tokens`` rows each routed to k
    distinct experts drawn from ``seed``, as ``sorted_expert_ffn`` pads
    them."""
    import numpy as np
    import torch

    from automodel_tpu_torch.ops import moe

    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(tokens)])
    _, _, padded, n_pad = moe.expert_segments(
        torch.from_numpy(idx.reshape(-1)), E, 128)
    return padded.int(), n_pad


# ---------------------------------------------------------------------------
# the DeepSeek-V2-Lite phases
# ---------------------------------------------------------------------------
LITE_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "deepseek_v2_lite_sft.yaml")
GEN_PROMPTS, GEN_NEW = 8, 32


def _bf16_ulps(got, want):
    """``|got - want|`` in units of ``want``'s bf16 ulp (2^(e - 8) for
    ``want = m 2^e``, m in [0.5, 1))."""
    import torch

    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                      (e - 8).clamp(min=-133))
    return (got.float() - want.float()).abs() / ulp


def _compared(attend, record, v_dim):
    """``attend`` (``ops/attention.py::attention``) that also runs the
    plain version on the same inputs and appends to ``record`` the share
    of output elements (valid rows, the first ``v_dim`` columns) whose
    bits differ and their largest and mean distance in bf16 ulps."""
    import torch

    def run(q, k, v, **kw):
        got = attend(q, k, v, **kw)
        want = attend(q, k, v, **{**kw, "impl": "plain"})
        mask = kw.get("attention_mask")
        rows = (torch.ones(got.shape[:2], dtype=torch.bool,
                           device=got.device) if mask is None else mask)
        g, w = got[..., :v_dim][rows], want[..., :v_dim][rows]
        d = _bf16_ulps(g, w)
        differ = g != w
        record.append(dict(share_differing=float(differ.float().mean()),
                           max_ulps=float(d.max()),
                           mean_ulps_differing=float(d[differ].mean())
                           if bool(differ.any()) else 0.0))
        return got
    return run


def _nudged(attend, gen):
    """``attend`` whose bf16 output has its last mantissa bit flipped in a
    seeded half of the elements (one ulp each)."""
    import torch

    def run(q, k, v, **kw):
        got = attend(q, k, v, **kw)
        check(got.dtype == torch.bfloat16,
              f"generate_deepseek: the nudge needs bf16, not {got.dtype}")
        flip = torch.randint(0, 2, got.shape, generator=gen,
                             device=got.device, dtype=torch.int16)
        return (got.view(torch.int16) ^ flip).view(torch.bfloat16)
    return run


def generate_deepseek_phase():
    """DeepSeek-V2-Lite (the SFT YAML's model, weights from seed 0) through
    ``generate()``: 8 ragged prompts of 64-512 tokens, 32 new each; the
    prefill through kernel 9 at head_dim 192 (one forward launch a layer),
    held against the plain-prefill run: the prefill's last logits within
    5 % of the logit range and the prompts' first tokens (the prefill's
    own output) equal.  Later tokens are reported, not gated: they decode
    over caches the two prefills wrote a few bf16 ulps apart, which a
    random-weight MoE's near-tied routes amplify (the token where each
    prompt's runs part is printed).  Two witnesses for that reading: each
    layer's prefill attention output, kernel against plain on the same
    inputs, in bf16 ulps (``prefill_attention_ulps``); and the plain run
    again with its prefill attention output moved by one ulp in a seeded
    half of the elements (``plain_nudged``), whose tokens part from the
    plain run's as the kernel's do."""
    import gc

    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation import GenerationConfig, generate
    from automodel_tpu_torch.generation.generate import left_align
    from automodel_tpu_torch.models import deepseek_v3 as dv3
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import splash_attention as sa

    cfg = load_yaml_config(LITE_YAML)
    model = cfg.model.instantiate(seed=0, device="cuda")
    mcfg = model.config
    rng = np.random.default_rng(3)
    lens = rng.integers(64, 513, GEN_PROMPTS)
    ids = rng.integers(1, mcfg.vocab_size, (GEN_PROMPTS, int(lens.max())))
    gcfg = GenerationConfig(max_new_tokens=GEN_NEW)
    generate(model, ids[:, :16], np.minimum(lens, 16),
             GenerationConfig(max_new_tokens=2))             # warm-up
    # the prefill alone: its last logits through kernel 9 and plain
    ids_t = torch.as_tensor(ids, device="cuda")
    lens_t = torch.as_tensor(lens, device="cuda")
    S = ids.shape[1]
    last, ulps, attend = {}, [], dv3.attention
    with torch.inference_mode():
        left = left_align(ids_t, lens_t, 0)
        mask = (torch.arange(S + 1, device="cuda")[None, :]
                >= (S - lens_t)[:, None])
        pos = (torch.arange(S, device="cuda")[None, :]
               - (S - lens_t)[:, None]).clamp(min=0)
        for impl in ("kernel", "plain"):
            cache = model.init_kv_cache(GEN_PROMPTS, S + 1)
            if impl == "kernel":        # each layer's output against plain
                dv3.attention = _compared(attend, ulps, mcfg.v_head_dim)
            try:
                last[impl] = model(left, position_ids=pos,
                                   attention_mask=mask, kv_cache=cache,
                                   cache_index=0, attn_impl=impl)[
                                       "logits"][:, -1].float()
            finally:
                dv3.attention = attend
            del cache
    span = float(last["plain"].abs().max())
    err = float((last["kernel"] - last["plain"]).abs().max())
    first = dict(max_abs_err=err, logit_range=span,
                 tol=LOGITS_REL_TOL * span,
                 argmax_equal=bool((last["kernel"].argmax(-1)
                                    == last["plain"].argmax(-1)).all()))
    check(err <= LOGITS_REL_TOL * span,
          f"generate_deepseek prefill logits: kernel vs plain max_abs_err "
          f"{err:.4f} > {LOGITS_REL_TOL} * {span:.3f}")
    out, times = {}, {}
    for impl in ("kernel", "plain"):
        torch.cuda.synchronize()
        sa.fwd_launches = sa.plain_fwd_calls = 0
        gk.gmm_launches = 0
        t0 = time.perf_counter()
        out[impl] = generate(model, ids, lens, gcfg, attn_impl=impl)
        torch.cuda.synchronize()
        times[impl] = time.perf_counter() - t0
        L, L_moe = mcfg.num_hidden_layers, moe_layer_count(model)
        want_fwd = L if impl == "kernel" else 0
        check(sa.fwd_launches == want_fwd,
              f"generate_deepseek ({impl} prefill): {sa.fwd_launches} "
              f"kernel 9 launches != {want_fwd}")
        check(gk.gmm_launches == 3 * L_moe * GEN_NEW,
              f"generate_deepseek: {gk.gmm_launches} gmm launches != 3 x "
              f"{L_moe} routed layers x {GEN_NEW} forwards")
        if impl == "kernel":
            launches = dict(attention_fwd=sa.fwd_launches,
                            gmm=gk.gmm_launches)
    # the witness: plain again, its prefill attention nudged by one ulp
    dv3.attention = _nudged(attend, torch.Generator(device="cuda")
                            .manual_seed(7))
    try:
        out["plain_nudged"] = generate(model, ids, lens, gcfg,
                                       attn_impl="plain")
    finally:
        dv3.attention = attend

    def parting(a_run, b_run):
        return _first_parting(out[a_run], out[b_run])

    same = bool((out["kernel"] == out["plain"]).all())
    parts = parting("kernel", "plain")
    report = dict(prompts=GEN_PROMPTS, prompt_lens=lens.tolist(),
                  new_tokens=GEN_NEW, kernel_prefill_s=times["kernel"],
                  plain_prefill_s=times["plain"],
                  tok_s=GEN_PROMPTS * GEN_NEW / times["kernel"],
                  launches=launches, prefill_logits=first,
                  first_tokens_equal=bool(
                      (out["kernel"][:, 0] == out["plain"][:, 0]).all()),
                  tokens_identical=same, first_parting_token=parts,
                  prefill_attention_ulps=ulps,
                  plain_nudged=dict(
                      nudged_share=0.5,
                      first_parting_token=parting("plain_nudged", "plain"),
                      first_tokens_equal=bool(
                          (out["plain_nudged"][:, 0]
                           == out["plain"][:, 0]).all())))
    print("generate_deepseek " + json.dumps(report), flush=True)
    check(report["first_tokens_equal"] and first["argmax_equal"],
          f"generate_deepseek: the prompts' first tokens differ between "
          f"the kernel and the plain prefill ({out['kernel'][:, 0]} vs "
          f"{out['plain'][:, 0]})")
    report["fp8"] = deepseek_fp8_leg(model, ids, lens, left, mask, pos, S,
                                     gcfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return report


def deepseek_fp8_leg(model, ids, lens, left, mask, pos, S, gcfg):
    """generate_deepseek with quantized compute (float8 tensorwise): the
    experts through gmm_quant, the MLA and dense projections plain (the
    JAX family's ``proj`` never quantizes), the prefill on kernel 9 at
    head_dim 192.  The prefill's last logits through the kernels against
    the plain versions (attention and gmm_quant) within 5 % of the logit
    range (or ``QUANT_GRAD_FLOOR_FACTOR`` floors, as ``fp8_serving_leg``
    measures them) and with the same argmax (the prompts' first tokens);
    then the
    ``GEN_NEW`` tokens through the kernels with the counts zeroed just
    before and read just after: kernel 9 once a layer, gmm_quant 3 times
    per routed layer and forward, the bf16 gmm and qdot never."""
    import torch

    from automodel_tpu_torch.generation import GenerationConfig, generate
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.quantization import fp8

    fp8.apply_fp8_to_model(model, fp8.FP8Config(enabled=True,
                                                dtype="float8"))
    mcfg = model.config
    L, L_moe = mcfg.num_hidden_layers, moe_layer_count(model)
    try:
        last = {}
        with torch.inference_mode():
            # (route, attention, quantized products)
            for route, attn, prod in (("kernel", "kernel", "kernel"),
                                      ("plain", "plain", "plain"),
                                      ("attn_plain", "plain", "kernel")):
                model.gmm_impl = model.qdot_impl = prod
                cache = model.init_kv_cache(GEN_PROMPTS, S + 1)
                last[route] = model(left, position_ids=pos,
                                    attention_mask=mask, kv_cache=cache,
                                    cache_index=0, attn_impl=attn)[
                                        "logits"][:, -1].float()
                del cache
        model.gmm_impl = model.qdot_impl = None
        span = float(last["plain"].abs().max())
        err = float((last["kernel"] - last["plain"]).abs().max())
        floor = float((last["kernel"] - last["attn_plain"]).abs().max())
        limit = max(LOGITS_REL_TOL * span, QUANT_GRAD_FLOOR_FACTOR * floor)
        argmax_equal = bool((last["kernel"].argmax(-1)
                             == last["plain"].argmax(-1)).all())
        check(err <= limit,
              f"generate_deepseek_fp8 prefill logits: kernels vs plain "
              f"max_abs_err {err:.4f} > {limit:.4f} (the larger of "
              f"{LOGITS_REL_TOL} x range {span:.3f} and "
              f"{QUANT_GRAD_FLOOR_FACTOR} x floor {floor:.4f})")
        torch.cuda.synchronize()
        sa.fwd_launches = sa.plain_fwd_calls = 0
        gk.gmm_launches = gq.gmm_quant_launches = qk.qdot_launches = 0
        t0 = time.perf_counter()
        out = generate(model, ids, lens, gcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(attention_fwd=sa.fwd_launches,
                        gmm_quant=gq.gmm_quant_launches,
                        gmm=gk.gmm_launches, qdot=qk.qdot_launches)
        short = GenerationConfig(max_new_tokens=8)
        profile = profile_window(lambda: generate(model, ids, lens, short),
                                 8, "generate_deepseek_fp8_w8",
                                 ("Splash<",))
    finally:
        model.quant = None
        model.gmm_impl = model.qdot_impl = None
    check(launches == dict(attention_fwd=L, gmm_quant=3 * L_moe * GEN_NEW,
                           gmm=0, qdot=0),
          f"generate_deepseek_fp8: launches {launches} (kernel 9 {L}, "
          f"gmm_quant 3 x {L_moe} routed layers x {GEN_NEW} forwards, "
          "gmm and qdot 0)")
    first_equal = bool((torch.as_tensor(out[:, 0], device="cuda")
                        == last["kernel"].argmax(-1)).all())
    report = dict(recipe="float8 tensorwise", prompts=GEN_PROMPTS,
                  new_tokens=GEN_NEW, wall_s=wall,
                  tok_s=GEN_PROMPTS * GEN_NEW / wall, launches=launches,
                  prefill_logits=dict(max_abs_err=err, logit_range=span,
                                      floor_max_abs_err=floor, limit=limit,
                                      argmax_equal=argmax_equal),
                  first_tokens_equal=argmax_equal and first_equal,
                  profile=profile)
    print("generate_deepseek_fp8 " + json.dumps(report), flush=True)
    check(report["first_tokens_equal"],
          "generate_deepseek_fp8: the prompts' first tokens differ between "
          "the kernel and the plain prefill")
    return report


# device-time buckets of a profiled window, by kernel name (first match)
KERNEL_KINDS = [
    # qdot, gmm_quant and their quantize pass (csrc/qdot.cu, gmm_quant.cu,
    # gemm8.cuh)
    ("quantized_mm", ("qdotk::", "gmmq::", "g8::")),
    # gmm, tgmm and tgmm's reduction of split groups (csrc/gmm.cu)
    ("grouped_mm", ("gmm_kernel", "tgmm_reduce")),
    ("linear_ce", ("lce_",)),           # before gemm: not cuBLAS GEMMs
    ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("loss", ("softmax", "nll_loss", "cross_entropy")),    # lower case
    ("optimizer", ("multi_tensor_apply", "foreach", "adam")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise_and_copy", ("elementwise", "copy", "index", "cat")),
]
# kernels whose own time and launches a profile line gives by name: tgmm's
# reduction of split groups, launched by every tgmm call with m above its
# row chunk (it finds no split group on the sorted path)
NAMED_KERNELS = ("tgmm_reduce",)


def traced_kernels(prof, steps):
    """``(device ms, launches, name)`` per step of each kernel a
    ``torch.profiler`` trace holds (its own time, the card's clock),
    largest first."""
    import torch

    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((dev_us / 1e3 / steps, evt.count / steps,
                            evt.key[:80]))
    return sorted(kernels, reverse=True)


def traced_device_ms(fn, iters, warmup=1):
    """Mean device time of ``fn``: the sum of its kernels' own times under
    ``torch.profiler`` (the card's activity only), so the host's gaps
    between the launches of an eager forward and backward are not
    counted, as CUDA events would count them; None where the trace shows
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = traced_kernels(prof, iters)
    return sum(k[0] for k in kernels) if kernels else None


def profile_window(run, steps, label, attn_names):
    """Run ``run()`` (``steps`` steps) under ``torch.profiler`` and print
    the host time per step, the device time per step (sum of the kernels'
    own times), the idle share, the attention kernels' time per step
    (kernel names containing one of ``attn_names``), the ``NAMED_KERNELS``'
    time and launches per step, and the kernels that take the most of
    it.  Only the card's activity is traced: tracing the host's operators
    too gives the same kernels and device times, but adds host time to the
    traced steps and makes reading the trace back several times longer,
    which made it the script's largest cost at the tens of thousands of
    launches a step of the HF YAMLs' phases."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = traced_kernels(prof, steps)
    device_ms = sum(k[0] for k in kernels)
    attn_ms = sum(k[0] for k in kernels
                  if any(n in k[2] for n in attn_names))
    by_kind = {}
    for ms, _, name in kernels:
        kind = next((kind for kind, keys in KERNEL_KINDS
                     if any(key in name.lower() for key in keys)), "other")
        if any(n in name for n in attn_names):
            kind = "attention"
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    report = dict(
        window=label, steps=steps, host_ms_per_step=host_ms,
        device_ms_per_step=device_ms if kernels else "not measured",
        device_idle_share=(1 - device_ms / host_ms) if kernels else None,
        attention_ms_per_step=attn_ms, ms_per_step_by_kind=by_kind,
        named={n: dict(ms_per_step=sum(k[0] for k in kernels if n in k[2]),
                       calls_per_step=sum(k[1] for k in kernels
                                          if n in k[2]))
               for n in NAMED_KERNELS},
        kernels_per_step=sum(k[1] for k in kernels),
        top=[dict(ms_per_step=k[0], calls_per_step=k[1], name=k[2])
             for k in kernels[:12]])
    print("profile " + json.dumps(report), flush=True)
    return report


# ---------------------------------------------------------------------------
# sft phase
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_attention_nudged(seed):
    """The plain attention (``ops/splash_attention.py::
    splash_attention_plain``) with its bf16 output moved by one ulp, up
    or down, in a seeded two thirds of its nonzero elements: another
    rounding of the same fp32 result, as right as the first."""
    import torch

    from automodel_tpu_torch.ops import splash_attention as sa

    real = sa.splash_attention_plain
    gens = {}

    def nudged(*args, **kw):
        out, lse = real(*args, **kw)
        if out.dtype == torch.bfloat16:
            gen = gens.get(out.device)
            if gen is None:
                gen = gens[out.device] = torch.Generator(
                    device=out.device).manual_seed(seed)
            step = torch.randint(-1, 2, out.shape, generator=gen,
                                 device=out.device, dtype=torch.int16)
            step = torch.where(out != 0, step, torch.zeros_like(step))
            out = (out.view(torch.int16) + step).view(torch.bfloat16)
        return out, lse

    sa.splash_attention_plain = nudged
    try:
        yield
    finally:
        sa.splash_attention_plain = real


def first_step_check(recipe, label, routes, compare, quantized=False,
                     rows=2, limits=None, floor_route="kernel_again",
                     floor_base="kernel", contexts=None, floor_factor=None):
    """Loss and whole gradient of the first step (``rows`` rows of the
    first batch, or all of it for None: flat patch rows cannot be cut by
    rows; the recipe's initial weights) through each route ``(name,
    loss_fn, attn_impl[, gmm_impl[, qdot_impl[, remat_policy]]])`` (the
    grouped matmuls', the quantized projections' routes and the model's
    remat policy, else its own); nothing is updated.  Each pair
    in ``compare`` must agree (``quantized``: the gradient within the
    quantized limit, derived from the run's own floor) within the loss and
    gradient limits, or within ``limits`` ``(loss_tol, grad_tol)`` where
    given.  ``kernel_again`` (a second kernel pass) shows the run-to-run
    spread (0 when every kernel of the route is deterministic); the floor
    is ``floor_base`` (the kernel route) against ``floor_route``, two
    equally right computations (by default ``kernel_again``).
    ``contexts`` maps a route's name to a context manager factory its pass
    runs under (``plain_attention_nudged``); with ``floor_factor`` the
    gradient's limit is the larger of the SFT limit and that many floors
    (a model whose gradient moves with the rounding of one operation).
    Returns the printed report."""
    import torch

    from automodel_tpu_torch.ops.remat import resolve_remat_policy
    from automodel_tpu_torch.training.train_step import (
        microbatch_loss,
        to_device_batch,
    )

    model = recipe.model
    own_policy = model.remat_policy
    # the trained parameters (under PEFT the adapters alone)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names = [n for n, _ in trained]
    first = next(iter(recipe.dataloader))
    mb = {k: v[0] for k, v in to_device_batch(
        [first if rows is None else {k: v[:rows] for k, v in first.items()}],
        recipe.device).items()}
    losses, grads, no_grad = {}, {}, {}
    for name, loss_fn, attn_impl, *impls in routes:
        if hasattr(model, "gmm_impl"):        # the MoE models' experts
            model.gmm_impl = impls[0] if impls else None
        model.qdot_impl = impls[1] if len(impls) > 1 else None
        model.remat_policy = (resolve_remat_policy(impls[2])
                              if len(impls) > 2 else own_policy)
        model.zero_grad(set_to_none=True)
        with (contexts or {}).get(name, contextlib.nullcontext)():
            loss = microbatch_loss(model, loss_fn, mb, attn_impl=attn_impl)
            loss.backward()
        torch.cuda.synchronize()
        losses[name] = float(loss.detach())
        # a trained leaf the forward does not use (Phi-4-multimodal's
        # vision-speech projectors) has no gradient: zeros, as in JAX.
        # Every route must leave the same leaves without one, so a kernel
        # backward that drops a gradient fails here
        no_grad[name] = sorted(n for n, p in trained if p.grad is None)
        check(no_grad[name] == next(iter(no_grad.values())),
              f"{label} first step ({name}): no gradient for "
              f"{no_grad[name]}, where {next(iter(no_grad))} has none for "
              f"{next(iter(no_grad.values()))}")
        grads[name] = [torch.zeros_like(p) if p.grad is None else p.grad
                       for _, p in trained]
        check(all(bool(torch.isfinite(g).all()) for g in grads[name]),
              f"{label} first step ({name}): non-finite gradient")
    model.zero_grad(set_to_none=True)
    if hasattr(model, "gmm_impl"):
        model.gmm_impl = None
    model.qdot_impl = None
    model.remat_policy = own_policy

    def rel_l2(a, b):
        num = den = 0.0
        per = []
        for n, x, y in zip(names, grads[a], grads[b]):
            d = float((x.float() - y.float()).square().sum())
            w = float(y.float().square().sum())
            num, den = num + d, den + w
            per.append(((d / max(w, 1e-30)) ** 0.5, n))
        return (num / den) ** 0.5, sorted(per, reverse=True)[:3]

    bitwise = {f"{a}_vs_{b}": losses[a] == losses[b] and all(
        torch.equal(x, y) for x, y in zip(grads[a], grads[b]))
        for a, b in compare}
    out = dict(rows=rows, losses=losses, bit_identical=bitwise,
               no_grad=next(iter(no_grad.values())),
               loss_tol=SFT_LOSS_REL_TOL,
               grad_tol=SFT_GRAD_REL_L2,
               grad_rel_l2_kernel_vs_kernel=rel_l2("kernel_again",
                                                   "kernel")[0],
               floor_route=floor_route, floor_base=floor_base,
               grad_rel_l2_floor=rel_l2(floor_route, floor_base)[0])
    for a, b in compare:
        rel_grad, worst = rel_l2(a, b)
        rel_loss = abs(losses[a] - losses[b]) / abs(losses[b])
        out[f"{a}_vs_{b}"] = dict(
            loss_rel_err=rel_loss, grad_rel_l2=rel_grad,
            worst_params=[dict(name=n, rel_l2=r) for r, n in worst])
    del grads
    torch.cuda.empty_cache()
    loss_tol, grad_tol = SFT_LOSS_REL_TOL, SFT_GRAD_REL_L2
    if quantized:
        grad_tol = min(QUANT_GRAD_REL_L2_CAP, max(
            SFT_GRAD_REL_L2,
            QUANT_GRAD_FLOOR_FACTOR * out["grad_rel_l2_floor"]))
    if floor_factor is not None:
        grad_tol = max(SFT_GRAD_REL_L2,
                       floor_factor * out["grad_rel_l2_floor"])
        out["floor_factor"] = floor_factor
    if limits is not None:
        loss_tol, grad_tol = limits
    out["loss_tol"], out["grad_tol"] = loss_tol, grad_tol
    print(f"{label} first step: " + json.dumps(out), flush=True)
    for a, b in compare:
        got = out[f"{a}_vs_{b}"]
        check(got["loss_rel_err"] <= loss_tol,
              f"{label} first-step loss {a} vs {b}: relative error "
              f"{got['loss_rel_err']:.3e} > {loss_tol:.3e}")
        check(got["grad_rel_l2"] <= grad_tol,
              f"{label} first-step gradient {a} vs {b}: relative L2 "
              f"{got['grad_rel_l2']:.3e} > {grad_tol:.3e}")
    return out


# The tight quantized check (phase quant_check): qdot kernel against qdot
# plain through a 2-layer Llama at sft_fp8's widths, the bench YAML's first
# batch, attention "plain" and every other op on one implementation on both
# sides, so qdot is the only difference.  int8: exact int32 sums and the
# same fp32 rescale make every product bit-identical, so loss and gradient
# must be too (limit 0; measured 0 and 0 on an H100 80GB HBM3 at 700 W).
# float8: both versions multiply the same codes, the kernel summing in fp32
# and the plain version in float64; the ~1e-7 relative differences flip
# the codes of values near a rounding midpoint in the next projection, and
# the flips compound.  Measured with the mma.sync qdot kernel (the same
# card, kernel-vs-kernel floor exactly 0): loss 1.59e-5, whole gradient
# 11.6 % relative L2.  The limits are about 6x and 2x those; an unrelated
# or mis-scaled gradient is O(100 %) off.
QUANT_CHECK_LAYERS = 2
INT8_CHECK_LIMITS = (0.0, 0.0)            # (loss rel err, gradient rel L2)
FP8_CHECK_LIMITS = (1e-4, 0.25)


def quant_check_phase():
    """qdot kernel vs plain through a 2-layer model, int8 then float8
    tensorwise; prints ``quant_check`` lines and fails past the limits."""
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    rows = []
    for dtype, limits in (("float8", FP8_CHECK_LIMITS),
                          ("int8", INT8_CHECK_LIMITS)):
        cfg = parse_args_and_load_config(
            ["-c", BENCH_YAML, "--step_scheduler.max_steps", "1",
             "--model.config.num_hidden_layers", str(QUANT_CHECK_LAYERS),
             "--fp8.enabled", "true", "--fp8.dtype", dtype])
        recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
            cfg).setup()
        loss_fn = recipe.loss_fn
        B = int(cfg.get("step_scheduler.local_batch_size"))
        out = first_step_check(
            recipe, f"quant_check_{dtype}",
            [("kernel", loss_fn, "plain", None, "kernel"),
             ("plain", loss_fn, "plain", None, "plain"),
             ("kernel_again", loss_fn, "plain", None, "kernel")],
            [("kernel", "plain")], rows=B, limits=limits)
        rows.append(dict(dtype=dtype, layers=QUANT_CHECK_LAYERS, **out))
        del recipe
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def lora_trainable_count(cfg, rank):
    """Adapter parameters of rank ``rank`` on all seven projections of a
    Llama config: layers x rank x sum over them of (in + out), the JAX
    ``LoRAModel.num_trainable_params``."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, \
        cfg.num_key_value_heads * cfg.head_dim
    shapes = ((H, q), (H, kv), (H, kv), (q, H), (H, I), (H, I), (I, H))
    return cfg.num_hidden_layers * rank * sum(i + o for i, o in shapes)


def peft_checks(recipe, label, base_before):
    """After a PEFT phase's steps: the frozen base (every parameter and
    buffer, an int8 base's codes and scales) bit for bit as before the
    first step, and an adapter save then load bit for bit; prints a
    ``peft_checks`` line."""
    import tempfile

    import torch

    from automodel_tpu_torch.peft.lora import load_adapters, save_adapters

    model = recipe.model
    after = list(model.base_model.state_dict().values())
    check(len(after) == len(base_before)
          and all(torch.equal(a.cpu(), b) for a, b in zip(after,
                                                          base_before)),
          f"{label}: the frozen base changed during training")
    params = list(model.adapters.parameters())
    before = [p.detach().clone() for p in params]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_adapters_") as d:
        save_adapters(model, d)
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        with torch.no_grad():
            for p in params:
                p.zero_()
        load_adapters(model, d)
    check(all(torch.equal(p.detach(), b) for p, b in zip(params, before)),
          f"{label}: adapters saved and loaded differ")
    out = dict(base_tensors=len(after), base_bit_identical=True,
               adapter_round_trip_bit_identical=True, adapter_bytes=nbytes,
               bypass=model.bypass)
    print(f"{label} peft_checks " + json.dumps(out), flush=True)
    return out


def shapes_report(groups, model):
    """The timed steps' batches (host numpy): per step each microbatch's
    ``[B, S]``, the rows counted by the multiple of 128 their tokens pad to
    (the tokens before the padding tail: the attention mask's, else the
    segments'), and the number of packed segments; over all steps the
    attention FLOPs counting causal S/2 keys per query within each segment
    (a padded row is one segment of its tokens; fwd + bwd = 3 x fwd, the
    remat re-forward not counted: ``attention_flops_per_token``'s
    convention applied per segment)."""
    import numpy as np

    # x s^2 for a segment of s: s tokens of s / 2 keys each
    per_sq = model.attention_flops_per_token(1)
    steps, flops = [], 0.0
    for g in groups:
        buckets, nseg = {}, 0
        for mb in g:
            seg = mb.get("segment_ids")
            if seg is None:
                seg = mb.get("attention_mask",
                              np.ones_like(mb["labels"])).astype(np.int64)
            for row in np.asarray(seg):
                lens = np.bincount(row[row > 0])[1:]
                lens = lens[lens > 0]
                nseg += len(lens)
                flops += per_sq * float((lens.astype(np.float64) ** 2).sum())
                n = int(lens.sum())
                key = str(-(-n // 128) * 128)
                buckets[key] = buckets.get(key, 0) + 1
        steps.append(dict(shapes=[list(mb["labels"].shape) for mb in g],
                          rows_by_length=dict(sorted(buckets.items())),
                          segments=nseg))
    return dict(steps=steps, attention_flops=flops,
                attention_convention="causal: s/2 keys per query within "
                "each segment of s tokens; fwd + bwd = 3 x fwd")


def sync_calls(recipe, group, label):
    """One more step's dispatch (``TrainStep.dispatch``, the loop's step
    without its bookkeeping) under ``torch.cuda.set_sync_debug_mode
    ("warn")``: the synchronizing calls it makes, counted from the
    warnings; prints a ``{label}_sync_calls`` line.  The batch is copied to
    the card before the window."""
    import warnings

    import torch

    from automodel_tpu_torch.training.train_step import to_device_batch

    batch = to_device_batch(group, recipe.device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            recipe.step_fns.dispatch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # each warning is attributed to the Python line that made the call
    sites = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
             for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    out = dict(calls=len(sites), sites=sorted(set(sites)))
    print(f"{label}_sync_calls " + json.dumps(out), flush=True)
    return out


# the first step with kept attention residuals against the same kernels
# recomputing them: the saved (out, lse) are the bits a recomputation
# gives (the kernels are deterministic), so the two are expected equal
# bit for bit; the limits (loss 1e-6, gradient 1e-4 relative L2) allow the
# summation order of another allocation
REMAT_LIMITS = (1e-6, 1e-4)
UNPACKED_OVERRIDES = [
    # bench.py's ``unpacked`` leg
    "--packed_sequence.packed_sequence_size", "0",
    "--dataset.mean_len", "1000", "--dataset.std_len", "30",
    "--dataset.max_sentence_len", "1100",
    "--dataloader.length_bucket_pool", "256"]
LONG_OVERRIDES = [
    # bench.py's ``long_context_16k`` leg
    "--packed_sequence.packed_sequence_size", "16384",
    "--step_scheduler.global_batch_size", "1",
    "--step_scheduler.local_batch_size", "1",
    "--dataset.num_sentences", "2048"]
RESIDUALS_OVERRIDES = ["--model.remat_policy", "save_names:splash_residuals"]
LONG_KV_GROUPS = (0, 7)       # kv heads whose 4 query heads run plain


def long_attention_case(seg_np):
    """The splash kernels at sft_long_16k's shape [1, 16384, 32 / 8, 64]
    with the segment ids of its first batch, against the plain versions on
    the query heads of the kv heads ``LONG_KV_GROUPS`` (a whole plain call
    would hold 34 GB of scores); kernel, one group's plain and bound
    times; prints an ``attention_case`` line."""
    import numpy as np
    import torch

    from automodel_tpu_torch.ops import splash_attention as sa

    dev = torch.device("cuda")
    B, S, Hq, Hk, D = 1, 16384, 32, 8, 64
    G = Hq // Hk
    g = torch.Generator(device=dev).manual_seed(160)
    q = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
    k = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
    v = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
    dout = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
    seg = torch.from_numpy(np.ascontiguousarray(seg_np[:B, :S])).to(dev)
    kw = dict(causal=True, segment_ids=seg)
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    fwd_err = bwd_err = 0.0
    rel = {}
    for h in LONG_KV_GROUPS:
        qs = slice(h * G, (h + 1) * G)
        ks = slice(h, h + 1)
        parts = (q[:, :, qs].contiguous(), k[:, :, ks].contiguous(),
                 v[:, :, ks].contiguous())
        ref, ref_lse = sa.splash_attention_plain(*parts, **kw)
        valid = (seg > 0)[0]
        diff = (out[:, :, qs].float() - ref.float()).abs()[0][valid]
        fwd_err = max(fwd_err, float(diff.max()))
        bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()[0][valid]
        check(not bool(bad.any()),
              f"long_16k kv head {h}: forward kernel disagrees with the "
              f"plain version (max_abs_err {fwd_err:.3e})")
        lse_err = float((lse[:, qs] - ref_lse).abs()[0][:, valid].max())
        check(lse_err <= 1e-2, f"long_16k kv head {h}: lse max_abs_err "
              f"{lse_err:.3e}")
        refs = sa.splash_attention_bwd_plain(
            *parts, ref, ref_lse, dout[:, :, qs].contiguous(), **kw)
        for name, got, want in zip(
                ("dq", "dk", "dv"),
                (grads[0][:, :, qs], grads[1][:, :, ks], grads[2][:, :, ks]),
                refs):
            r = float((got.float() - want.float()).norm()
                      / want.float().norm())
            rel[f"{name}_kv{h}"] = r
            bwd_err = max(bwd_err, float((got.float() - want.float())
                                         .abs().max()))
            check(r <= GRAD_REL_L2, f"long_16k kv head {h}: backward "
                  f"{name} relative L2 {r:.3e} > {GRAD_REL_L2}")
        del ref, ref_lse, refs
        torch.cuda.empty_cache()
    parts = (q[:, :, :G].contiguous(), k[:, :, :1].contiguous(),
             v[:, :, :1].contiguous())
    plain_fwd = time_ms(lambda: sa.splash_attention_plain(*parts, **kw), 1,
                        None, warmup=1)
    lens = np.bincount(seg_np[0][seg_np[0] > 0])[1:].astype(np.int64)
    pairs = int((lens * (lens + 1) // 2).sum())
    fb, fby = attn_bound(q, k, seg, pairs, backward=False)
    bb, bby = attn_bound(q, k, seg, pairs, backward=True)
    row = dict(case="long_16k_packed_d64", B=B, S=S, Hq=Hq, Hk=Hk, D=D,
               packed=True, segments=len(lens), attended_pairs=pairs,
               plain_on_kv_heads=list(LONG_KV_GROUPS),
               fwd=dict(ms=time_ms(lambda: sa.flash_attn_fwd_cuda(
                   q, k, v, **kw), 10, None),
                   plain_ms_one_kv_head=plain_fwd, bound_ms=fb,
                   bound_by=fby, max_abs_err=fwd_err),
               bwd=dict(ms=time_ms(lambda: sa.flash_attn_bwd_cuda(
                   q, k, v, out, lse, dout, **kw), 10, None),
                   bound_ms=bb, bound_by=bby, max_abs_err=bwd_err,
                   rel_l2=rel))
    print("attention_case " + json.dumps(row), flush=True)
    del q, k, v, dout, out, lse, grads
    torch.cuda.empty_cache()
    return row


def model_dims(model):
    """A decoder's widths under one set of names (GPT-2's config names
    its own: ``n_embd``, ``n_layer``, ``n_head``, a 4x MLP)."""
    c = model.config
    if c.model_type == "gpt2":
        return dict(vocab=c.vocab_size, hidden=c.n_embd, ffn=4 * c.n_embd,
                    layers=c.n_layer, heads=c.n_head, kv_heads=c.n_head,
                    head_dim=c.n_embd // c.n_head)
    return dict(vocab=c.vocab_size, hidden=c.hidden_size,
                ffn=c.intermediate_size, layers=c.num_hidden_layers,
                heads=c.num_attention_heads, kv_heads=c.num_key_value_heads,
                head_dim=c.head_dim)


def train_phase(label, yaml_path, overrides=(), bf16=None, attn_impl=None,
                first_step=None, sync_report=False, on_setup=None,
                on_end=None):
    """Set up the SFT recipe on ``yaml_path`` (plus CLI ``overrides``),
    check its first step, run
    2 warm-up steps, then the timed steps with every launch count zeroed
    just before and read just after, then a profiled window.  With the
    fused linear CE (the bench and MoE YAMLs) the linear-CE counts are held
    to one forward per microbatch and one launch of each backward kernel
    per chunk of rows, and the loader must be the async input pipeline.
    An MoE model (the MoE YAML) first runs the grouped-matmul kernel phase
    on its routed group sizes; its first step is held against every kernel's
    plain version, and its grouped-matmul counts to 9 gmm launches (3
    forward, 3 in the remat re-forward, 3 dlhs) and 3 tgmm launches per
    layer and microbatch; a dense model launches none.  With quantized
    compute on (``--fp8.enabled true``) every dense projection launches
    qdot 4 times per layer and microbatch (forward, remat re-forward, dx,
    dw), the MoE experts run gmm_quant 9 times (and no bf16 gmm) beside
    the 3 bf16 tgmm, the first step is held against every kernel's plain
    version, and ``bf16`` (the same YAML's unquantized report) gives the
    loss after 8 steps to print beside this one's.  Under PEFT (the PEFT
    YAML) the first step's adapter gradients are held against every
    kernel's plain version, the frozen tied head launches no linear-CE
    dW, the trainable count must be the JAX model's, and the base must
    come out of the steps bit for bit (``peft_checks``).  ``attn_impl="flash"``
    sends the train step's attention through the flash rung: its kernels
    are held to 2 forward launches per layer and microbatch and 1
    backward, the splash kernels to none, and the first step runs against
    the plain attention.  An MoE model's first step is also held kernel
    against kernel (``kernel_again``), bit for bit (the routed block's
    gather and combine add in a fixed order; ``ops/moe.py``).
    ``first_step="all_plain"`` adds to the fused
    loss's first-step check a route through every kernel's plain version
    (the attention's included); ``"remat"`` holds the first step against
    the same kernels under ``nothing_saveable`` instead (the phase's model
    keeps the attention residuals: its forward kernel launches once per
    layer and microbatch).  The timed steps' batches are recorded on the
    host as the loop takes them: their shapes give the token counts and
    the linear-CE launches per step, and the ``{label}_shapes`` line the
    rows' lengths per step.  ``sync_report`` runs one warmed step's
    dispatch under ``torch.cuda.set_sync_debug_mode("warn")`` and prints
    the synchronizing calls it makes.  ``on_setup(recipe)`` runs right
    after set-up (its dict joins the report), ``on_end(recipe, report)``
    after the profiled window."""
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.datasets.prefetch import PrefetchDataLoader
    from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.recipes.llm import train_ft

    cfg = parse_args_and_load_config(
        ["-c", yaml_path, "--step_scheduler.max_steps", str(SFT_WARMUP),
         *overrides])
    t0 = time.perf_counter()
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    recipe.step_fns.attn_impl = attn_impl
    flash = attn_impl == "flash"
    torch.cuda.synchronize()
    mcfg = recipe.model.config
    dims = model_dims(recipe.model)
    L = dims["layers"]
    fused = isinstance(recipe.loss_fn, FusedLinearCrossEntropy)
    is_moe = hasattr(recipe.model, "gmm_impl")
    quant = getattr(recipe.model, "quant", None)
    quantized = quant is not None and quant.enabled
    peft = recipe.peft_config
    ffn = (f"{moe_widths(recipe.model)[0]} experts of "
           f"{moe_widths(recipe.model)[1]}, top-{mcfg.num_experts_per_tok}"
           f" in {moe_layer_count(recipe.model)} layers" if is_moe
           else str(dims["ffn"]))
    print(f"{label}: {type(recipe.model).__name__} widths (vocab "
          f"{dims['vocab']}, hidden {dims['hidden']}, ffn {ffn}, layers "
          f"{L}, heads {dims['heads']}/{dims['kv_heads']}, head_dim "
          f"{dims['head_dim']}), "
          f"{sum(p.numel() for p in recipe.model.parameters())} params "
          f"{recipe.model.param_dtype}, remat {recipe.model.remat_policy}, "
          f"quantized compute {quant if quantized else 'off'}, "
          f"loss {type(recipe.loss_fn).__name__}, attention "
          f"{attn_impl or 'splash'}, loader "
          f"{type(recipe.dataloader).__name__}, "
          f"set up in {time.perf_counter() - t0:.1f} s", flush=True)
    setup_report = on_setup(recipe) if on_setup is not None else None
    base_before = None
    if peft is not None:
        # the frozen base as it was before any step (host copies)
        base_before = [t.cpu().clone() for t in
                       recipe.model.base_model.state_dict().values()]
        trainable = sum(p.numel() for p in recipe.model.parameters()
                        if p.requires_grad)
        want = lora_trainable_count(mcfg, peft.dim)
        print(f"{label} peft_trainable " + json.dumps(dict(
            trainable=trainable, jax_formula=want,
            num_trainable_params=recipe.model.num_trainable_params,
            rank=peft.dim, targets=sorted(recipe.model.targets),
            bypass=recipe.model.bypass,
            quantize_base=peft.quantize_base)), flush=True)
        check(trainable == want == recipe.model.num_trainable_params,
              f"{label}: {trainable} trainable parameters != the JAX "
              f"model's {want}")
    gmm_rows = None
    if is_moe:
        gmm_rows = (gmm_quant_phase if quantized else gmm_phase)(
            recipe, first_batch(yaml_path))
    if fused:
        check(isinstance(recipe.dataloader, PrefetchDataLoader),
              f"{label}: the loader is {type(recipe.dataloader).__name__}, "
              "not the async input pipeline")
        plain = FusedLinearCrossEntropy(chunk_len=recipe.loss_fn.chunk_len,
                                        impl="plain")
    if peft is not None:
        # the adapters' gradients, every kernel against its plain version
        first_step_check(
            recipe, label,
            [("kernel", recipe.loss_fn, "kernel"),
             ("plain", plain, "plain"),
             ("kernel_again", recipe.loss_fn, "kernel")],
            [("kernel", "plain")])
    elif is_moe or quantized:
        # every kernel of the path against its plain version
        fs = first_step_check(
            recipe, label,
            [("kernel", recipe.loss_fn, "kernel", "kernel", "kernel"),
             ("plain", plain, "plain", "plain", "plain"),
             ("kernel_again", recipe.loss_fn, "kernel", "kernel", "kernel")]
            # the quantized products alone through their plain versions,
            # and the floor: the attention alone through its plain version
            + ([("quant_plain", recipe.loss_fn, "kernel", "kernel", "plain"),
                ("attn_plain", recipe.loss_fn, "plain", "kernel", "kernel")]
               if quantized else []),
            [("kernel", "plain")]
            + ([("kernel", "quant_plain")] if quantized else [])
            + ([("kernel", "kernel_again")] if is_moe else []),
            quantized=quantized,
            floor_route="attn_plain" if quantized else "kernel_again")
        check(not is_moe or fs["bit_identical"]["kernel_vs_kernel_again"],
              f"{label}: two kernel runs of the first step differ "
              f"(gradient relative L2 "
              f"{fs['grad_rel_l2_kernel_vs_kernel']:.3e})")
    elif flash:
        first_step_check(
            recipe, label,
            [("kernel", recipe.loss_fn, "flash"),
             ("plain", recipe.loss_fn, "plain"),
             ("kernel_again", recipe.loss_fn, "flash")],
            [("kernel", "plain")])
    elif first_step == "remat":
        # the same kernels, the residuals kept and recomputed
        first_step_check(
            recipe, label,
            [("kernel", recipe.loss_fn, "kernel"),
             ("nothing_saveable", recipe.loss_fn, "kernel", None, None,
              "nothing_saveable"),
             ("kernel_again", recipe.loss_fn, "kernel")],
            [("kernel", "nothing_saveable")], limits=REMAT_LIMITS)
    elif fused:
        routes = [("kernel", recipe.loss_fn, "kernel"),
                  ("plain", plain, "kernel"),
                  ("masked_ce", MaskedCrossEntropy(), "kernel"),
                  ("kernel_again", recipe.loss_fn, "kernel")]
        compare = [("kernel", "plain"), ("kernel", "masked_ce")]
        if first_step == "all_plain":
            routes.append(("all_plain", plain, "plain"))
            compare.append(("kernel", "all_plain"))
        first_step_check(recipe, label, routes, compare)
    else:
        first_step_check(
            recipe, label,
            [("plain", recipe.loss_fn, "plain"),
             ("kernel", recipe.loss_fn, "kernel"),
             ("kernel_again", recipe.loss_fn, "kernel")],
            [("kernel", "plain")])

    # the groups the loop takes, as numpy on the host
    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    recipe.run_train_validation_loop()                   # warm-up steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    produced_s = getattr(recipe.dataloader, "produce_s", 0.0)
    # counts zeroed just before the timed steps
    sa.fwd_launches = sa.bwd_launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    lce.fwd_launches = lce.dlogits_launches = lce.dh_launches = 0
    lce.dw_launches = 0
    gk.gmm_launches = gk.tgmm_launches = 0
    qk.qdot_launches = gq.gmm_quant_launches = 0
    recipe.step_scheduler.max_steps = SFT_WARMUP + SFT_STEPS
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the wrapper refers to the recipe: left in place, the recipe (and its
    # weights and optimizer state) would outlive the phase until the cycle
    # collector ran
    del recipe._run_train_optim_step
    attn, other = (fa, sa) if flash else (sa, fa)
    fwd, bwd = attn.fwd_launches, attn.bwd_launches
    other_counts = (other.fwd_launches, other.bwd_launches)
    lce_counts = dict(fwd=lce.fwd_launches, dlogits=lce.dlogits_launches,
                      dh=lce.dh_launches, dw=lce.dw_launches)
    gmm_counts = dict(gmm=gk.gmm_launches, tgmm=gk.tgmm_launches,
                      gmm_quant=gq.gmm_quant_launches)
    qdot_count = qk.qdot_launches
    peak = torch.cuda.max_memory_allocated()
    timed = recipe.history[SFT_WARMUP:]
    check(len(timed) == SFT_STEPS, f"{label} ran {len(timed)} timed steps")
    groups = seen[SFT_WARMUP:SFT_WARMUP + SFT_STEPS]
    check(len(groups) == SFT_STEPS, f"{label}: recorded {len(groups)} groups")
    shapes = [[mb["labels"].shape for mb in g] for g in groups]
    B, S = shapes[0][0]
    micro = SFT_STEPS * recipe.step_scheduler.grad_acc_steps
    rung = "flash" if flash else "splash"
    # kept residuals: the backward does not run the forward kernel again
    per_layer = 1 if "splash_residuals" in recipe.model.remat_policy.names \
        else 2
    check(fwd == per_layer * L * micro,
          f"{label}: {fwd} {rung} forward kernel launches != {per_layer} x "
          f"{L} layers x {micro} microbatches (remat "
          f"{recipe.model.remat_policy})")
    check(bwd == L * micro,
          f"{label}: {bwd} {rung} backward kernel launches != {L} layers x "
          f"{micro} microbatches")
    check(other_counts == (0, 0),
          f"{label}: the other attention rung launched {other_counts}")
    # each microbatch's T = rows x row length; a chunk of rows per launch
    per_call = sum(lce.bwd_launches_per_call(b * t) for g in shapes
                   for b, t in g)
    # a frozen head (PEFT) takes no dW
    want = (dict(fwd=micro, dlogits=per_call, dh=per_call,
                 dw=0 if peft is not None else per_call) if fused
            else dict.fromkeys(lce_counts, 0))
    check(lce_counts == want,
          f"{label}: linear-CE launches {lce_counts} != {want} ({micro} "
          f"microbatches of shapes {shapes}, {per_call} backward chunks)")
    experts = ("gmm_quant" if quantized else "gmm")
    want = dict(gmm=0, tgmm=0, gmm_quant=0)
    L_moe = moe_layer_count(recipe.model) if is_moe else 0
    if is_moe:
        want.update({experts: 9 * L_moe * micro, "tgmm": 3 * L_moe * micro})
    check(gmm_counts == want,
          f"{label}: grouped-matmul launches {gmm_counts} != {want} ({L_moe} "
          f"routed layers x {micro} microbatches; per layer 3 forward, 3 "
          f"remat re-forward and 3 dlhs {experts}, 3 tgmm)")
    # the projections through maybe_qdot: q, k, v, o, and the dense
    # SwiGLU's gate, up, down (every width here a multiple of 16)
    projections = 4 if is_moe else 7
    want_qdot = 4 * projections * L * micro if quantized else 0
    check(qdot_count == want_qdot,
          f"{label}: qdot launches {qdot_count} != {want_qdot} ({L} layers "
          f"x {micro} microbatches x {projections} projections x 4: "
          "forward, remat re-forward, dx, dw)")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
        print(f"{label} step {m['step']}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} step_time {m['step_time']:.4f} s",
              flush=True)
    tokens = sum(b * t for g in shapes for b, t in g)
    tok_s = tokens / wall
    flops_per_token = (recipe.model.flops_per_token()
                       + recipe.model.attention_flops_per_token(S))
    shape_line = shapes_report(groups, recipe.model)
    print(f"{label}_shapes " + json.dumps(shape_line), flush=True)
    report = dict(
        yaml=os.path.relpath(yaml_path, REPO), loss=type(
            recipe.loss_fn).__name__,
        loader=type(recipe.dataloader).__name__,
        steps=SFT_STEPS, batch=B, seq_len=S, tokens=tokens, wall_s=wall,
        step_ms=wall * 1e3 / SFT_STEPS, tokens_per_s=tok_s,
        nonpad_tokens_per_s=sum(m["tps"] * m["step_time"] for m in timed)
        / wall, flops_per_token=flops_per_token,
        mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
        mfu_no_attention=tok_s * recipe.model.flops_per_token()
        / BF16_OPS_PER_S,
        mfu_attention_by_segment=(tokens * recipe.model.flops_per_token()
                                  + shape_line["attention_flops"])
        / wall / BF16_OPS_PER_S,
        remat_policy=str(recipe.model.remat_policy),
        attention=rung, fwd_launches=fwd, bwd_launches=bwd,
        linear_ce_launches=lce_counts,
        gmm_launches=gmm_counts, qdot_launches=qdot_count,
        quant=dataclasses.asdict(quant) if quantized else None,
        loss_after_8_steps=recipe.history[7]["loss"],
        bf16_loss_after_8_steps=(bf16["loss_after_8_steps"] if bf16
                                 else None),
        producer_host_s=getattr(recipe.dataloader, "produce_s", 0.0)
        - produced_s,
        peak_mem_bytes=peak,
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history])
    print(f"{label}_run " + json.dumps(report), flush=True)
    if sync_report:
        report["sync_calls"] = sync_calls(recipe, groups[-1], label)

    def more():
        recipe.step_scheduler.max_steps += SFT_PROFILED
        recipe.run_train_validation_loop()

    # the attention kernels' names carry their rung type (csrc/attn_core.cuh)
    prof = profile_window(more, SFT_PROFILED, f"{label}_b{B}_s{S}",
                          ("Mha<",) if flash else ("Splash<",))
    check(prof["device_ms_per_step"] == "not measured"
          or prof["attention_ms_per_step"] > 0,
          f"{label}: the profile counts no attention kernel by name")
    report["profile"] = prof
    report["gmm_cases"] = gmm_rows
    if peft is not None:
        report["peft"] = peft_checks(recipe, label, base_before)
    if setup_report is not None:
        report.update(setup_report)
    if on_end is not None:
        on_end(recipe, report)
    return report


# ---------------------------------------------------------------------------
# ckpt phase
# ---------------------------------------------------------------------------
CKPT_SAVES = 1          # per mode: inline, then asynchronous
# the bench YAML's depth in the ckpt phase: 4 of 16 layers, widths kept
# (the saves' bytes, and so the phase's time, fall to ~40 %; cut for the
# script's time limit when the Phi-4-multimodal and VLM-decode phases came)
CKPT_LAYERS = 4


def _states_equal(a, b):
    """Bitwise equality of two (nested) state dicts."""
    import numpy as np
    import torch

    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu())))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_states_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_states_equal(x, y) for x, y in zip(a, b)))
    return a == b


def ckpt_phase():
    """The bench YAML at full width and ``CKPT_LAYERS`` layers with
    checkpointing on (``keep_last_k``
    1, a temporary directory removed at the end): CKPT_SAVES inline saves,
    then CKPT_SAVES asynchronous ones, one training step before each, with
    the train-loop stall and the background commit time of each; every
    committed directory passes ``verify_manifest``.  Then a fresh recipe
    on the same directory resumes from the last committed step with the
    weights, optimizer state, schedule, RNG, step and loader position
    bitwise equal to the saved ones, and its next step's loss is within
    SFT_LOSS_REL_TOL of the uninterrupted run's."""
    import shutil
    import tempfile

    import torch

    from automodel_tpu_torch.checkpoint import checkpointing as ck
    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        print(f"ckpt: directory {root}, {free} bytes free", flush=True)
        check(free > 40e9, f"ckpt: only {free} bytes free under {root}")

        def recipe(max_steps):
            cfg = parse_args_and_load_config(
                ["-c", BENCH_YAML, "--model.config.num_hidden_layers",
                 str(CKPT_LAYERS), "--checkpoint.enabled", "true",
                 "--checkpoint.checkpoint_dir", root,
                 "--checkpoint.keep_last_k", "1",
                 "--step_scheduler.ckpt_every_steps", "0",
                 "--step_scheduler.max_steps", str(max_steps)])
            return train_ft.TrainFinetuneRecipeForNextTokenPrediction(
                cfg).setup()

        run = recipe(0)
        check(run.step_scheduler.step == 0, "ckpt: resumed from a stale dir")
        saves = []
        for async_save in (False, True):
            run.checkpoint_config.async_save = async_save
            for _ in range(CKPT_SAVES):
                # one step, then the loop's save at max_steps (the async
                # commit is joined when the loop returns)
                run.step_scheduler.max_steps += 1
                run.run_train_validation_loop()
                torch.cuda.synchronize()
                t = run.ckpt_timings[-1]
                latest = ck.find_latest_checkpoint(root)
                check(latest == t["path"], f"ckpt: newest is {latest}, "
                      f"saved {t['path']}")
                manifest = ck.verify_manifest(latest)
                saves.append(dict(async_save=async_save,
                                  step=manifest["step"],
                                  stall_ms=t["stall_s"] * 1e3,
                                  background_ms=t["background_s"] * 1e3,
                                  bytes=t["bytes"]))
                print("ckpt_save " + json.dumps(saves[-1]), flush=True)
        committed = ck.list_committed_checkpoints(root)
        check(len(committed) == 1, f"ckpt: keep_last_k 1 left {committed}")
        for _, _, path in committed:
            ck.verify_manifest(path)

        saved = dict(rng=run.rng.state_dict(),
                     loader=run.dataloader.state_dict())
        t0 = time.perf_counter()
        resumed = recipe(run.step_scheduler.step + 1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(resumed.step_scheduler.step == run.step_scheduler.step,
              f"ckpt: resumed at step {resumed.step_scheduler.step}, saved "
              f"{run.step_scheduler.step}")
        equal = dict(
            weights=_states_equal(run.model.state_dict(),
                                  resumed.model.state_dict()),
            optimizer=_states_equal(run.optimizer.state_dict(),
                                    resumed.optimizer.state_dict()),
            schedule=_states_equal(run.lr_scheduler.state_dict(),
                                   resumed.lr_scheduler.state_dict()),
            rng=_states_equal(saved["rng"], resumed.rng.state_dict()),
            step_scheduler=_states_equal(
                run.step_scheduler.state_dict(),
                resumed.step_scheduler.state_dict()),
            loader=_states_equal(saved["loader"],
                                 resumed.dataloader.state_dict()))
        check(all(equal.values()), f"ckpt: resumed state differs: {equal}")
        run.checkpoint_config.enabled = False
        resumed.checkpoint_config.enabled = False
        run.step_scheduler.max_steps += 1
        run.run_train_validation_loop()
        resumed.run_train_validation_loop()
        want, got = run.history[-1]["loss"], resumed.history[-1]["loss"]
        rel = abs(got - want) / abs(want)
        check(rel <= SFT_LOSS_REL_TOL,
              f"ckpt: the resumed step's loss {got} vs {want} ({rel:.3e})")

        def mean(xs):
            return sum(xs) / len(xs)

        report = dict(
            yaml=os.path.relpath(BENCH_YAML, REPO), saves=saves,
            inline_stall_ms=mean([x["stall_ms"] for x in saves
                                  if not x["async_save"]]),
            async_stall_ms=mean([x["stall_ms"] for x in saves
                                 if x["async_save"]]),
            async_background_ms=mean([x["background_ms"] for x in saves
                                      if x["async_save"]]),
            checkpoint_bytes=saves[-1]["bytes"], restore_s=restore_s,
            resumed_step=resumed.step_scheduler.step - 1,
            bitwise_equal=equal, next_loss=got, uninterrupted_loss=want,
            next_loss_rel_err=rel)
        print("ckpt_run " + json.dumps(report), flush=True)
        del run, resumed
        return report
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the JAX package's HF fine-tuning YAMLs, and Qwen2.5 served
# ---------------------------------------------------------------------------
HF_YAMLS = os.path.join(REPO, "examples", "llm_finetune")
QWEN3_HELLASWAG_YAML = os.path.join(HF_YAMLS, "qwen3",
                                    "qwen3_0p6b_hellaswag.yaml")
LLAMA_SQUAD_YAML = os.path.join(HF_YAMLS, "llama3_2", "llama3_2_1b_squad.yaml")
QWEN2_SERVE_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                                "qwen2_5_1p5b_serve.yaml")
# the published config.json of each model (the keys HF writes; the port
# reads the ones it knows), under the repo id the YAMLs name
HF_CONFIGS = {
    "Qwen/Qwen3-0.6B": dict(
        architectures=["Qwen3ForCausalLM"], attention_bias=False,
        attention_dropout=0.0, bos_token_id=151643, eos_token_id=151645,
        head_dim=128, hidden_act="silu", hidden_size=1024,
        initializer_range=0.02, intermediate_size=3072,
        max_position_embeddings=40960, max_window_layers=28,
        model_type="qwen3", num_attention_heads=16, num_hidden_layers=28,
        num_key_value_heads=8, rms_norm_eps=1e-06, rope_scaling=None,
        rope_theta=1000000, sliding_window=None, tie_word_embeddings=True,
        torch_dtype="bfloat16", use_cache=True, use_sliding_window=False,
        vocab_size=151936),
    "meta-llama/Llama-3.2-1B": dict(
        architectures=["LlamaForCausalLM"], attention_bias=False,
        attention_dropout=0.0, bos_token_id=128000, eos_token_id=128001,
        head_dim=64, hidden_act="silu", hidden_size=2048,
        initializer_range=0.02, intermediate_size=8192,
        max_position_embeddings=131072, mlp_bias=False, model_type="llama",
        num_attention_heads=32, num_hidden_layers=16, num_key_value_heads=8,
        pretraining_tp=1, rms_norm_eps=1e-05,
        rope_scaling={"factor": 32.0, "high_freq_factor": 4.0,
                      "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192,
                      "rope_type": "llama3"},
        rope_theta=500000.0, tie_word_embeddings=True,
        torch_dtype="bfloat16", use_cache=True, vocab_size=128256),
    "Qwen/Qwen2.5-1.5B-Instruct": dict(
        architectures=["Qwen2ForCausalLM"], attention_dropout=0.0,
        bos_token_id=151643, eos_token_id=151645, hidden_act="silu",
        hidden_size=1536, initializer_range=0.02, intermediate_size=8960,
        max_position_embeddings=32768, max_window_layers=21,
        model_type="qwen2", num_attention_heads=12, num_hidden_layers=28,
        num_key_value_heads=2, rms_norm_eps=1e-06, rope_theta=1000000.0,
        sliding_window=32768, tie_word_embeddings=True,
        torch_dtype="bfloat16", use_cache=True, use_sliding_window=False,
        vocab_size=151936),
}
# (warm-up, timed) steps; the SQuAD YAML validates every 10 steps
HF_STEPS = {"sft_qwen3_hellaswag": (2, 6), "sft_llama_squad": (2, 8)}
# the depth the HF phases run at for the script's 1200 s limit (every
# width as published): Qwen3-0.6B 7 of 28 layers, Llama-3.2-1B 4 of 16,
# Qwen2.5-1.5B (serve_qwen2) 14 of 28; the classifier's Llama-3.2-1B 4 of
# 16 (SEQCLS_LAYERS).  At full depth, with GRPO / DPO at 16 layers too,
# the script ended at 1109.7 s (NVIDIA H100 80GB HBM3, 700 W); the two
# SFT phases and the classifier went from half to a quarter of their
# layers when the quantized-serving and fleet legs joined (the script at
# 1,000.4 s before this cut on one H100 80GB HBM3 at 700 W)
HF_LAYERS = {"sft_qwen3_hellaswag": 7, "sft_llama_squad": 4,
             "serve_qwen2": 14}
HF_PUBLISHED_LAYERS = {"sft_qwen3_hellaswag": 28, "sft_llama_squad": 16,
                       "serve_qwen2": 28}
HF_SEEDS = {"Qwen/Qwen3-0.6B": 6, "meta-llama/Llama-3.2-1B": 12,
            "Qwen/Qwen2.5-1.5B-Instruct": 25}
WORDS = ("the", "a", "man", "woman", "dog", "ball", "kitchen", "river",
         "then", "slowly", "runs", "jumps", "takes", "puts", "into", "over",
         "while", "his", "her", "bright", "water", "table", "rope", "hand",
         "camera", "shows", "people", "playing", "outside", "holding",
         "begins", "finally", "another", "several", "around", "across")


class ByteTokenizer:
    """A duck-typed HF tokenizer over bytes (id ``b + 4``; pad 0, bos 1,
    eos 2), a bos in front unless ``add_special_tokens`` is False; called
    on a string or a list of strings.  The phases hand it to the recipe
    through ``tokenizer._target_`` (no tokenizer files are on the card's
    machine); its ids lie below every vocabulary here."""

    pad_token, bos_token, eos_token = "<pad>", "<s>", "</s>"
    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2
    all_special_ids = [0, 1, 2]

    def encode(self, text, add_special_tokens=True):
        return ([1] if add_special_tokens else []) + [b + 4 for b in
                                                      text.encode()]

    def __call__(self, text, add_special_tokens=True):
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens)
            return {"input_ids": ids, "attention_mask": [1] * len(ids)}
        ids = [self.encode(t, add_special_tokens) for t in text]
        return {"input_ids": ids,
                "attention_mask": [[1] * len(i) for i in ids]}


def _words(rng, lo, hi):
    return " ".join(WORDS[i] for i in rng.integers(
        0, len(WORDS), int(rng.integers(lo, hi + 1))))


def hellaswag_rows(n, seed):
    """Rows in HellaSwag's schema, about 60-150 tokens a context and gold
    ending under :class:`ByteTokenizer` (the published set's lengths)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"ind": i, "ctx": _words(rng, 8, 20),
             "endings": [_words(rng, 3, 8) for _ in range(4)],
             "label": str(int(rng.integers(0, 4)))} for i in range(n)]


def squad_rows(n, seed):
    """Rows in SQuAD's schema, about 150-400 tokens a prompt and answer
    under :class:`ByteTokenizer`; the answer a span of the context."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ctx = _words(rng, 25, 60)
        words = ctx.split()
        a = int(rng.integers(0, len(words) - 3))
        answer = " ".join(words[a:a + int(rng.integers(1, 4))])
        rows.append({"id": str(i), "title": "t", "context": ctx,
                     "question": _words(rng, 5, 12) + "?",
                     "answers": {"text": [answer],
                                 "answer_start": [ctx.find(answer)]}})
    return rows


def write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def write_hf_model(hf_home, repo_id, layers=None, hold=None):
    """Write the published config and random bf16 weights from ``seed``
    (biases too, away from 0) as the ``refs/main`` snapshot of
    ``repo_id`` under ``hf_home`` (``save_hf_weights``, then the published
    ``config.json``; the config is ``HF_CONFIGS[repo_id]`` and the seed
    ``HF_SEEDS[repo_id]``, or ``FAMILY_CONFIGS`` / ``FAMILY_SEEDS``);
    ``layers`` cuts the depth (the config's ``num_hidden_layers``);
    returns ``(snapshot dir, the written tensors that the phase checks,
    on the host)``: a sample of names, or those ``hold(name)`` picks."""
    import torch

    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import AutoModelForCausalLM

    if repo_id in HF_CONFIGS:
        cfg, seed = HF_CONFIGS[repo_id], HF_SEEDS[repo_id]
    else:
        cfg, seed = FAMILY_CONFIGS[repo_id], FAMILY_SEEDS[repo_id]
    if layers is not None:
        cfg = dict(cfg, num_hidden_layers=layers)
    repo = os.path.join(hf_home, "hub", "models--" + repo_id.replace("/",
                                                                      "--"))
    snap = os.path.join(repo, "snapshots", f"seed{seed}")
    t0 = time.perf_counter()
    model = AutoModelForCausalLM.from_config(cfg, seed=seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, device="cuda", generator=g)
                        * 0.5)
    hf_io.save_hf_weights(model, snap)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(f"seed{seed}")
    L = cfg["num_hidden_layers"]
    sample = [n for n, _, _ in hf_io.hf_tensors(model)
              if (hold(n) if hold is not None else
                  n in ("model.embed_tokens.weight", "model.norm.weight",
                        "model.layers.0.self_attn.q_proj.weight",
                        "model.layers.0.self_attn.k_norm.weight",
                        f"model.layers.{L - 1}.mlp.down_proj.weight")
                  or n.endswith("_proj.bias"))]
    written = {n: t.detach().cpu().clone() for n, t, _ in
               hf_io.hf_tensors(model) if n in sample}
    nbytes = sum(os.path.getsize(os.path.join(snap, f))
                 for f in os.listdir(snap))
    del model
    torch.cuda.empty_cache()
    print(f"hf_model {repo_id}: {snap} ({nbytes} bytes) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return snap, written


def loaded_equal(label, model, written):
    """The model's HF tensors named in ``written`` equal them bit for bit;
    returns how many were held."""
    import torch

    from automodel_tpu_torch.models import hf_io

    got = {n: t for n, t, _ in hf_io.hf_tensors(model) if n in written}
    check(sorted(got) == sorted(written),
          f"{label}: the model lacks {sorted(set(written) - set(got))}")
    for name, want in written.items():
        t = got[name].detach().cpu()
        # a bf16 tensor read into an fp32 parameter widens exactly
        widened = t.dtype == torch.float32 and want.dtype == torch.bfloat16
        check((t.dtype == want.dtype or widened)
              and bool(torch.equal(t, want.to(t.dtype))),
              f"{label}: {name} as loaded differs from the written tensor")
    return len(written)


def hf_sft_phase(label, yaml_path, repo_id, kind, hf_home, flush):
    """A JAX HF fine-tuning YAML as written through the port's recipe on
    the card, at its model's published config and depth (random bf16
    weights from a seed in an ``HF_HOME`` snapshot under the YAML's repo
    id), with only these overrides: the two dataset sources (local jsonl
    rows in the set's schema, ``kind`` "hellaswag" or "squad"),
    ``tokenizer._target_`` (:class:`ByteTokenizer`), the step count and
    the checkpoint directory.  Gates: the loaded weights equal the written
    ones bit for bit (a sample of tensors); kernel 9 at the model's heads
    on the first batch's rows (its padding folded into segments) and, for
    a vocabulary no earlier phase trains, kernels 2-4 at the first
    microbatch's labels, each against its plain version; the first step
    (2 rows) through every kernel against every plain version within the
    SFT limits; the exact launch counts of kernel 9 and kernels 2-4 over
    the steps (validation batches included).  Reports step time,
    tokens/s, MFU, peak memory, the validation loss over the 64
    validation rows and a profiled window's idle share."""
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.recipes.llm import train_ft

    warmup, steps = HF_STEPS[label]
    snap, written = write_hf_model(hf_home, repo_id, layers=HF_LAYERS[label])
    work = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    key = "path_or_dataset" if kind == "hellaswag" else "dataset_name"
    make = hellaswag_rows if kind == "hellaswag" else squad_rows
    train = write_jsonl(os.path.join(work, "train.jsonl"), make(2048, 1))
    val = write_jsonl(os.path.join(work, "validation.jsonl"), make(256, 2))
    cfg = parse_args_and_load_config(
        ["-c", yaml_path, "--step_scheduler.max_steps", str(warmup + steps),
         f"--dataset.{key}", train, f"--validation_dataset.{key}", val,
         "--tokenizer._target_", "chip_smoke.ByteTokenizer",
         "--checkpoint.checkpoint_dir", os.path.join(work, "checkpoints")])
    t0 = time.perf_counter()
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, mcfg = recipe.model, recipe.model.config
    L = mcfg.num_hidden_layers
    held = loaded_equal(label, model, written)
    check(model.checkpoint_dir == snap,
          f"{label}: the model came from {model.checkpoint_dir}, not {snap}")
    check(isinstance(recipe.loss_fn, FusedLinearCrossEntropy),
          f"{label}: loss {type(recipe.loss_fn).__name__}")
    print(f"{label}: {type(model).__name__} {mcfg.model_type} (vocab "
          f"{mcfg.vocab_size}, hidden {mcfg.hidden_size}, ffn "
          f"{mcfg.intermediate_size}, layers {L} of "
          f"{HF_PUBLISHED_LAYERS[label]} (depth cut for the time limit), "
          f"heads {mcfg.num_attention_heads}/{mcfg.num_key_value_heads}, "
          f"head_dim {mcfg.head_dim}, qk_norm {mcfg.qk_norm}), "
          f"{model.num_params} "
          f"params {model.param_dtype}, from {snap}, {held} written tensors "
          f"held bit for bit; loader {type(recipe.dataloader).__name__} of "
          f"{len(recipe.dataloader)} batches, set up in {setup_s:.1f} s",
          flush=True)

    # the kernels at this path's shapes: the first batch's rows (padding
    # folded into segments: 0 = no key), its first microbatch's labels
    first = next(iter(recipe.dataloader))
    B, S = first["input_ids"].shape
    mask = first.get("attention_mask")
    seg = (mask if mask is not None else
           (first["input_ids"] * 0 + 1)).astype("int32")
    name = f"{label}_d{mcfg.head_dim}"
    attn_rows = attention_phase(
        flush, seg, [(name, B, S, mcfg.num_attention_heads,
                      mcfg.num_key_value_heads, mcfg.head_dim, True, None,
                      None)])
    lce_row = None
    if mcfg.vocab_size not in (128256, 102400):
        lce_row = lce_case(f"{label}_v{mcfg.vocab_size}", B * S,
                           mcfg.hidden_size, mcfg.vocab_size, "bench",
                           first["labels"], flush, seed=300, parts=True)
    torch.cuda.empty_cache()

    plain = FusedLinearCrossEntropy(chunk_len=recipe.loss_fn.chunk_len,
                                    impl="plain")
    first_step = first_step_check(
        recipe, label,
        [("kernel", recipe.loss_fn, "kernel"), ("plain", plain, "plain"),
         ("kernel_again", recipe.loss_fn, "kernel")],
        [("kernel", "plain")])

    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    n_val = len(recipe.val_dataloader)
    val_every = recipe.step_scheduler.val_every_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0     # zeroed just before the run
    lce.fwd_launches = lce.dlogits_launches = lce.dh_launches = 0
    lce.dw_launches = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = dict(attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                  lce_fwd=lce.fwd_launches, dlogits=lce.dlogits_launches,
                  dh=lce.dh_launches, dw=lce.dw_launches)
    peak = torch.cuda.max_memory_allocated()
    del recipe._run_train_optim_step
    check(len(recipe.history) == warmup + steps == len(seen),
          f"{label}: {len(recipe.history)} steps, {len(seen)} groups")
    shapes = [[mb["labels"].shape for mb in g] for g in seen]
    micro = sum(len(g) for g in shapes)
    vals = len(recipe.val_history)
    check(vals == (warmup + steps) // val_every,
          f"{label}: {vals} validations in {warmup + steps} steps "
          f"(val_every_steps {val_every})")
    per_call = sum(lce.bwd_launches_per_call(b * t) for g in shapes
                   for b, t in g)
    want = dict(attn_fwd=2 * L * micro + L * n_val * vals,
                attn_bwd=L * micro, lce_fwd=micro + n_val * vals,
                dlogits=per_call, dh=per_call, dw=per_call)
    check(counts == want,
          f"{label}: launches {counts} != {want} ({micro} microbatches of "
          f"{shapes}, {vals} validations of {n_val} batches)")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
    timed = recipe.history[warmup:]
    timed_shapes = shapes[warmup:]
    tokens = sum(b * t for g in timed_shapes for b, t in g)
    step_s = sum(m["step_time"] for m in timed)
    tok_s = tokens / step_s
    if vals == 0:      # the YAML validates later: the 64 rows, read once
        val_loss = recipe._run_validation_epoch()
    else:
        val_loss = recipe.val_history[-1][1]
    check(math.isfinite(val_loss), f"{label}: validation loss {val_loss}")

    # a profiled window of two more steps (no checkpoint in it)
    recipe.checkpoint_config.enabled = False

    def more():
        recipe.step_scheduler.max_steps += SFT_PROFILED
        recipe.run_train_validation_loop()

    prof = profile_window(more, SFT_PROFILED,
                          f"{label}_b{timed_shapes[0][0][0]}_s"
                          f"{timed_shapes[0][0][1]}", ("Splash<",))
    flops = (model.flops_per_token()
             + model.attention_flops_per_token(timed_shapes[0][0][1]))
    report = dict(
        yaml=os.path.relpath(yaml_path, REPO), repo_id=repo_id,
        snapshot=snap, written_tensors_held=held, setup_s=setup_s,
        warmup_steps=warmup, steps=steps, shapes=[
            sorted({f"{b}x{t}" for b, t in g}) for g in timed_shapes],
        tokens=tokens, step_ms=step_s * 1e3 / steps,
        step_ms_each=[m["step_time"] * 1e3 for m in timed],
        tokens_per_s=tok_s,
        nonpad_tokens_per_s=sum(m["tps"] * m["step_time"] for m in timed)
        / step_s, flops_per_token=flops,
        mfu=tok_s * flops / BF16_OPS_PER_S, loop_s=loop_s,
        peak_mem_bytes=peak, launches=counts,
        validation=dict(batches=n_val, loss=val_loss,
                        at_steps=[s for s, _ in recipe.val_history]),
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history],
        first_step=dict(loss_rel_err=first_step["kernel_vs_plain"][
            "loss_rel_err"], grad_rel_l2=first_step["kernel_vs_plain"][
            "grad_rel_l2"]),
        profile=prof)
    print(f"{label}_run " + json.dumps(report), flush=True)
    report["attention_cases"], report["lce_case"] = attn_rows, lce_row
    del recipe, model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)),
                  ignore_errors=True)
    return report


def serve_qwen2_phase(hf_home, flush):
    """Qwen2.5-1.5B-Instruct at its published config and 14 of its 28
    layers (``HF_LAYERS``; q / k / v biases, G 6, the window fields off),
    written as an
    ``HF_HOME`` snapshot and loaded by ``AutoModelForCausalLM.
    from_pretrained(..., load_weights=True)``: every q / k / v bias and a
    sample of the other tensors bit for bit as written, then the engine
    phase (``qwen2_5_1p5b_serve.yaml``'s serving: first-step logits
    kernel against plain, the 16 requests with paged decode held to
    layers x steps, profiled windows), then n-gram speculation on and off
    (the
    verify width, S 5) on periodic prompts with the same launch gate and
    the same tokens."""
    import numpy as np
    import torch

    from automodel_tpu_torch.models.auto_model import AutoModelForCausalLM

    repo_id = "Qwen/Qwen2.5-1.5B-Instruct"
    snap, written = write_hf_model(hf_home, repo_id,
                                   layers=HF_LAYERS["serve_qwen2"])
    print(f"serve_qwen2: {HF_LAYERS['serve_qwen2']} of "
          f"{HF_PUBLISHED_LAYERS['serve_qwen2']} layers (depth cut for the "
          "time limit), every width as published", flush=True)
    t0 = time.perf_counter()
    model = AutoModelForCausalLM.from_pretrained(repo_id, load_weights=True,
                                                 device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(model.checkpoint_dir == snap, f"serve_qwen2: from {snap}?")
    check(model.config.attention_bias and model.sliding_window is None,
          "serve_qwen2: the published config built another model")
    held = loaded_equal("serve_qwen2", model, written)
    biases = sum(n.endswith("bias") for n in written)
    check(biases == 3 * model.config.num_hidden_layers,
          f"serve_qwen2: {biases} biases held")
    print(f"serve_qwen2: loaded {snap} in {load_s:.1f} s, {held} tensors "
          f"({biases} q / k / v biases) bit for bit", flush=True)
    report = engine_phase(QWEN2_SERVE_YAML, "serve_qwen2", model=model)
    rng = np.random.default_rng(0)
    motif = [int(t) for t in rng.integers(1, 2000, 6)]
    reqs = [((motif * 5)[:24], 0) for _ in range(16)]
    base = dict(max_num_seqs=8, max_model_len=72)
    off = feature_run(model, "serve_qwen2_spec_off", base, reqs, 48)
    on = feature_run(model, "serve_qwen2_spec_on",
                     {**base, "speculative": "ngram", "spec_k": 4}, reqs, 48)
    _identical("serve_qwen2 speculative: on vs off", on[1], off[1])
    st = on[2].stats()
    check(st["speculative"]["tokens_proposed"] > 0,
          "serve_qwen2: speculation proposed nothing")
    report["speculative"] = dict(
        on=on[0], off=off[0], accept_rate=st["accept_rate"],
        step_widths=st["step_widths"], tokens_identical_on_vs_off=True)
    report.update(load_s=load_s, written_tensors_held=held,
                  biases_held=biases)
    print("serve_qwen2_run " + json.dumps(
        {k: v for k, v in report.items() if k not in ("profile_mixed",
                                                      "profile_decode")}),
        flush=True)
    del model, on, off
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)),
                  ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# the VLM recipe: Gemma-3-VL through finetune vlm (the bench YAML as
# written, and Gemma-3-4B-it at its published widths on CORD-v2's schema)
# ---------------------------------------------------------------------------
VLM_YAMLS = os.path.join(REPO, "examples", "vlm_finetune")
GEMMA3_BENCH_YAML = os.path.join(VLM_YAMLS, "gemma3_vl_bench.yaml")
GEMMA3_CORD_YAML = os.path.join(VLM_YAMLS, "gemma3_vl_cord_v2.yaml")
GEMMA3_4B = "google/gemma-3-4b-it"
GEMMA3_4B_LAYERS = 6                  # of 34 (see MOE_SERVE_LAYERS)
# Gemma-3-4B-it's published config.json, every text field written out (the
# JAX Gemma3Config defaults vocab_size to 262,144, HF to 262,208: the file
# must not lean on a default)
GEMMA3_4B_CONFIG = dict(
    architectures=["Gemma3ForConditionalGeneration"], boi_token_index=255999,
    eoi_token_index=256000, eos_token_id=[1, 106], image_token_index=262144,
    initializer_range=0.02, mm_tokens_per_image=256, model_type="gemma3",
    torch_dtype="bfloat16",
    text_config=dict(
        model_type="gemma3_text", vocab_size=262208, hidden_size=2560,
        intermediate_size=10240, num_hidden_layers=GEMMA3_4B_LAYERS,
        num_attention_heads=8, num_key_value_heads=4, head_dim=256,
        query_pre_attn_scalar=256, sliding_window=1024,
        rope_scaling={"factor": 8.0, "rope_type": "linear"},
        rope_theta=1000000.0, rope_local_base_freq=10000.0,
        rms_norm_eps=1e-6, max_position_embeddings=131072,
        attention_bias=False, hidden_activation="gelu_pytorch_tanh",
        final_logit_softcapping=None, attn_logit_softcapping=None,
        tie_word_embeddings=True, torch_dtype="bfloat16"),
    vision_config=dict(
        model_type="siglip_vision_model", hidden_size=1152, image_size=896,
        intermediate_size=4304, num_attention_heads=16,
        num_hidden_layers=27, patch_size=14, layer_norm_eps=1e-6,
        vision_use_head=False))
GEMMA3_4B_SEED = 17
# the mock processor at the 4B's widths: (896 / 56)^2 = 256 placeholders,
# the model's mm_tokens_per_image
GEMMA3_4B_PROCESSOR = ["--processor._target_",
                       "automodel_tpu.datasets.vlm.mock.MockVLMProcessor",
                       "--processor.vocab_size", "262208",
                       "--processor.image_size", "896",
                       "--processor.patch_size", "56",
                       "--processor.image_token_id", "262144"]
VLM_STEPS = {"sft_gemma3_vl_bench": (2, 6, 2),
             "sft_gemma3_4b_cord": (1, 2, 1)}     # warm-up, timed, profiled
CORD_ROWS = 192
# kernel 9 at the Gemma shapes: the bench YAML's rows (16 / 8 heads, D 128,
# window 512), Gemma-3-4B's (8 / 4, D 256, window 1024) at S 4096, where
# the window bites, and Gemma-2-2B's (8 / 4, D 256, cap 50, window 4096)
GEMMA_ATTN_CASES = [
    ("gemma3_bench_window512_d128", 8, 2048, 16, 8, 128, False, 512, None),
    ("gemma3_bench_causal_d128", 8, 2048, 16, 8, 128, False, None, None),
    ("gemma3_4b_window1024_d256", 2, 4096, 8, 4, 256, False, 1024, None),
    ("gemma3_4b_causal_d256", 2, 4096, 8, 4, 256, False, None, None),
    ("gemma2_2b_cap50_window4096_d256", 2, 4096, 8, 4, 256, False, 4096,
     50.0),
]


def cord_rows(work, n, seed):
    """``n`` rows in CORD-v2's schema as a local jsonl: ``ground_truth`` a
    JSON string with ``gt_parse`` (menu items of several words each, the
    total), ``image`` a local ``.npy`` of a receipt-sized uint8 image; the
    answers' words put rows at 512-1024 tokens with the 256 image tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(work, "images"), exist_ok=True)
    rows = []
    for i in range(n):
        items, words = [], int(rng.integers(250, 700))
        while words > 0:
            k = int(min(words, rng.integers(4, 16)))
            items.append({"nm": " ".join(rng.choice(WORDS, k)),
                          "cnt": str(int(rng.integers(1, 5))),
                          "price": f"{int(rng.integers(1, 99))},000"})
            words -= k
        gt = {"gt_parse": {"menu": items, "total": {
            "total_price": f"{int(rng.integers(10, 999))},000"}}}
        path = os.path.join(work, "images", f"{i}.npy")
        np.save(path, rng.integers(0, 256, (320, 240, 3)).astype(np.uint8))
        rows.append({"ground_truth": json.dumps(gt), "image": path})
    return write_jsonl(os.path.join(work, "cord.jsonl"), rows)


def gemma3_sample(cfg):
    """The Gemma-3 VL tensors :func:`write_vlm_model` keeps to check the
    load against."""
    L = cfg["text_config"]["num_hidden_layers"]
    lm, vt = "model.language_model.", "model.vision_tower.vision_model."
    return {lm + "embed_tokens.weight", lm + "norm.weight",
            lm + "layers.0.self_attn.q_proj.weight",
            lm + "layers.5.self_attn.k_norm.weight",
            lm + f"layers.{L - 1}.post_feedforward_layernorm.weight",
            lm + f"layers.{L - 1}.mlp.down_proj.weight",
            vt + "embeddings.patch_embedding.weight",
            vt + "embeddings.position_embedding.weight",
            vt + "encoder.layers.26.self_attn.out_proj.bias",
            vt + "post_layernorm.weight",
            "model.multi_modal_projector.mm_input_projection_weight",
            "model.multi_modal_projector.mm_soft_emb_norm.weight"}


def write_vlm_model(hf_home, repo_id, cfg, seed, sample=gemma3_sample,
                    norm_center=0.0):
    """The published config with random bf16 weights from ``seed`` as the
    ``refs/main`` snapshot of ``repo_id`` under ``hf_home`` (norm weights
    ``norm_center`` + N(0, 0.1): Gemma's zero-centred ones, or 1 for the
    families that scale by ``w``; biases N(0, 0.1)); returns ``(snapshot,
    the written tensors ``sample(cfg)`` names, on the host)``."""
    import torch

    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )

    repo = os.path.join(hf_home, "hub", "models--" + repo_id.replace("/",
                                                                      "--"))
    snap = os.path.join(repo, "snapshots", f"seed{seed}")
    free = shutil.disk_usage(hf_home).free
    check(free > 40e9, f"{repo_id}: {free} bytes free under {hf_home}; the "
          "snapshot (~8.6 GB) and the phase's checkpoint need ~40 GB")
    t0 = time.perf_counter()
    model = AutoModelForImageTextToText.from_config(
        cfg, seed=seed, device="cuda", param_dtype="bfloat16")
    with torch.no_grad():     # the norms and biases away from their init
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if name.endswith(("norm.weight", "norm1.weight", "norm2.weight",
                              "ln_q.weight")):
                p.copy_(norm_center + torch.randn(
                    p.shape, device="cuda", generator=g) * 0.1)
            elif name.endswith("bias"):
                p.copy_(torch.randn(p.shape, device="cuda", generator=g)
                        * 0.1)
    hf_io.save_hf_weights(model, snap)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(f"seed{seed}")
    sample = sample(cfg)
    written = {n: t.detach().cpu().clone() for n, t, _ in
               hf_io.hf_tensors(model) if n in sample}
    check(sorted(written) == sorted(sample),
          f"{repo_id}: the writer lacks {sorted(sample - set(written))}")
    nbytes = sum(os.path.getsize(os.path.join(snap, f))
                 for f in os.listdir(snap))
    del model
    torch.cuda.empty_cache()
    print(f"hf_model {repo_id}: {snap} ({nbytes} bytes) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return snap, written


def vlm_sft_phase(label, yaml_path, overrides, flush, written=None,
                  snap=None):
    """A VLM fine-tuning YAML through the port's VLM recipe on the card
    (``recipes/vlm/finetune.py``, what ``automodel-torch finetune vlm``
    runs) with ``overrides``.  Gates: the loaded weights bit for bit as
    written (``written``, from an ``HF_HOME`` snapshot); kernel 9 at the
    model's heads and window on the first batch's rows and kernels 2-4 at
    its labels, each against its plain version; the first step (2 rows)
    through every kernel against every plain version within the SFT
    limits; the exact launch counts over the steps (kernel 9: 2 x layers x
    microbatches forward under remat, layers x microbatches backward;
    linear CE one forward per microbatch, one dlogits and dh per chunk of
    rows, dW only when the tied head is trainable).  Reports step time,
    text tokens/s, images/s, MFU from both towers by the work the step
    does (text tokens x ``flops_per_token`` less the frozen tied head's dW,
    + images x ``flops_per_image``, a third of it for a frozen tower that
    runs forward only, over the bf16 peak) and ``mfu_bench_convention``
    (both counts in full, as ``bench.py``'s ``vlm`` leg counts them), peak
    memory and a profiled window's idle share and kernels a step.  The
    first batch's kernel-9 case carries the segment ids the model folds
    from that batch: none, as the collate (like the JAX one) gives neither
    segment ids nor a padding mask."""
    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import (
        dispatched_window,
        fold_padding_into_segments,
    )
    from automodel_tpu_torch.recipes.vlm.finetune import FinetuneRecipeForVLM

    warmup, steps, profiled = VLM_STEPS[label]
    cfg = parse_args_and_load_config(
        ["-c", yaml_path, "--step_scheduler.max_steps", str(warmup + steps),
         *overrides])
    t0 = time.perf_counter()
    recipe = FinetuneRecipeForVLM(cfg).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = recipe.model
    tcfg, vcfg = model.config.text_config, model.config.vision_config
    lm = model.language_model
    L = tcfg.num_hidden_layers
    held = 0
    if written is not None:
        held = loaded_equal(label, model, written)
        check(model.checkpoint_dir == snap,
              f"{label}: the model came from {model.checkpoint_dir}")
    check(isinstance(recipe.loss_fn, FusedLinearCrossEntropy),
          f"{label}: loss {type(recipe.loss_fn).__name__}")
    windows = [None if layer.full else tcfg.sliding_window
               for layer in lm.layers]
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    head_trained = lm.embed_tokens.weight.requires_grad
    tower_trained = any(p.requires_grad
                        for p in model.vision_tower.parameters())
    print(f"{label}: {type(model).__name__} text (vocab {tcfg.vocab_size}, "
          f"hidden {tcfg.hidden_size}, ffn {tcfg.intermediate_size}, layers "
          f"{L} ({windows.count(None)} full, the others window "
          f"{tcfg.sliding_window}), heads {tcfg.num_attention_heads}/"
          f"{tcfg.num_key_value_heads}, head_dim {tcfg.head_dim}), vision "
          f"(hidden {vcfg.hidden_size}, ffn {vcfg.intermediate_size}, layers "
          f"{vcfg.num_hidden_layers}, image {vcfg.image_size} / patch "
          f"{vcfg.patch_size}), {model.num_params} params "
          f"{model.param_dtype}, {trainable} trainable (tied head "
          f"{'trained' if head_trained else 'frozen'}, vision tower "
          f"{'trained' if tower_trained else 'frozen'}), {held} written "
          f"tensors held bit for bit; loader "
          f"{type(recipe.dataloader).__name__}, set up in {setup_s:.1f} s",
          flush=True)

    first = next(iter(recipe.dataloader))
    B, S = first["input_ids"].shape
    seg = fold_padding_into_segments(
        (B, S), *(None if first.get(key) is None
                  else torch.as_tensor(np.asarray(first[key]))
                  for key in ("segment_ids", "attention_mask")))
    win = dispatched_window(tcfg.sliding_window, S)
    attn_rows = attention_phase(
        flush, None if seg is None else seg.numpy(), [(
            f"{label}_first_batch_{'causal' if win is None else f'w{win}'}"
            f"_d{tcfg.head_dim}",
            B, S, tcfg.num_attention_heads, tcfg.num_key_value_heads,
            tcfg.head_dim, seg is not None, win, None)])
    lce_row = lce_case(f"{label}_v{tcfg.vocab_size}", B * S,
                       tcfg.hidden_size, tcfg.vocab_size, "bench",
                       first["labels"], flush, seed=310, parts=True)
    torch.cuda.empty_cache()
    plain = FusedLinearCrossEntropy(chunk_len=recipe.loss_fn.chunk_len,
                                    impl="plain")
    first_step = first_step_check(
        recipe, label,
        [("kernel", recipe.loss_fn, "kernel"), ("plain", plain, "plain"),
         ("kernel_again", recipe.loss_fn, "kernel")],
        [("kernel", "plain")])

    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0     # zeroed just before the run
    lce.fwd_launches = lce.dlogits_launches = lce.dh_launches = 0
    lce.dw_launches = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = dict(attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                  lce_fwd=lce.fwd_launches, dlogits=lce.dlogits_launches,
                  dh=lce.dh_launches, dw=lce.dw_launches)
    peak = torch.cuda.max_memory_allocated()
    del recipe._run_train_optim_step
    check(len(recipe.history) == warmup + steps == len(seen),
          f"{label}: {len(recipe.history)} steps, {len(seen)} groups")
    shapes = [[mb["labels"].shape for mb in g] for g in seen]
    micro = sum(len(g) for g in shapes)
    per_call = sum(lce.bwd_launches_per_call(b * t) for g in shapes
                   for b, t in g)
    want = dict(attn_fwd=2 * L * micro, attn_bwd=L * micro, lce_fwd=micro,
                dlogits=per_call, dh=per_call,
                dw=per_call if head_trained else 0)
    check(counts == want,
          f"{label}: launches {counts} != {want} ({micro} microbatches of "
          f"{shapes})")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
    timed = recipe.history[warmup:]
    groups = seen[warmup:]
    tokens = sum(b * t for g in shapes[warmup:] for b, t in g)
    images = sum(int(np.asarray(mb["pixel_values"]).reshape(
        *mb["pixel_values"].shape[:2], -1).any(-1).sum())
        for g in groups for mb in g)
    step_s = sum(m["step_time"] for m in timed)
    tok_s, img_s = tokens / step_s, images / step_s
    fpt, fpi = model.flops_per_token(), model.flops_per_image()
    # the work the step does: a frozen tied head computes no dW (2 V H a
    # token less than fpt's 6 V H) and a frozen tower runs forward only
    # (2x its MACs, not fpi's 6x)
    fpt_done = fpt - (0.0 if head_trained
                      else 2.0 * tcfg.vocab_size * tcfg.hidden_size)
    fpi_done = fpi if tower_trained else fpi / 3.0
    row_len = shapes[warmup][0][1]
    recipe.checkpoint_config.enabled = False

    def more():
        recipe.step_scheduler.max_steps += profiled
        recipe.run_train_validation_loop()

    prof = profile_window(more, profiled,
                          f"{label}_b{shapes[warmup][0][0]}_s{row_len}",
                          ("Splash<",))
    report = dict(
        yaml=os.path.relpath(yaml_path, REPO), overrides=list(overrides),
        snapshot=snap, written_tensors_held=held, setup_s=setup_s,
        warmup_steps=warmup, steps=steps,
        shapes=[sorted({f"{b}x{t}" for b, t in g}) for g in shapes[warmup:]],
        microbatches_per_step=len(shapes[warmup]), text_tokens=tokens,
        images=images, step_ms=step_s * 1e3 / steps,
        step_ms_each=[m["step_time"] * 1e3 for m in timed],
        text_tokens_per_s=tok_s, images_per_s=img_s,
        label_tokens_per_s=sum(m["num_label_tokens"] for m in timed)
        / step_s, flops_per_token=fpt, flops_per_image=fpi,
        flops_per_token_done=fpt_done, flops_per_image_done=fpi_done,
        mfu=(tok_s * fpt_done + img_s * fpi_done) / BF16_OPS_PER_S,
        mfu_with_attention=(tok_s * (
            fpt_done + model.attention_flops_per_token(row_len))
            + img_s * fpi_done) / BF16_OPS_PER_S,
        mfu_bench_convention=(tok_s * fpt + img_s * fpi) / BF16_OPS_PER_S,
        loop_s=loop_s, peak_mem_bytes=peak, launches=counts,
        trainable_params=trainable, head_trained=head_trained,
        vision_tower_trained=tower_trained,
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history],
        first_step=dict(loss_rel_err=first_step["kernel_vs_plain"][
            "loss_rel_err"], grad_rel_l2=first_step["kernel_vs_plain"][
            "grad_rel_l2"]),
        profile=prof)
    print(f"{label}_run " + json.dumps(report), flush=True)
    report["attention_cases"], report["lce_case"] = attn_rows, lce_row
    del recipe, model, lm
    gc.collect()
    torch.cuda.empty_cache()
    return report


def gemma3_4b_cord_phase(hf_home, flush):
    """``gemma3_vl_cord_v2.yaml`` at Gemma-3-4B-it's published widths: the
    repo id resolved to an ``HF_HOME`` snapshot of its published config
    with random bf16 weights, the mock processor at its widths, local
    jsonl rows in CORD-v2's schema; batch 32 / 2, the frozen vision tower
    and embeddings, the fused loss, the clip and ``mu_dtype`` as written.
    The overrides are on the phase's line."""
    work = tempfile.mkdtemp(prefix="chip_smoke_cord_")
    snap, written = write_vlm_model(hf_home, GEMMA3_4B, GEMMA3_4B_CONFIG,
                                    GEMMA3_4B_SEED)
    overrides = [*GEMMA3_4B_PROCESSOR,
                 "--dataset.path_or_dataset", cord_rows(work, CORD_ROWS, 23),
                 "--checkpoint.checkpoint_dir",
                 os.path.join(work, "checkpoints")]
    print("sft_gemma3_4b_cord overrides: " + " ".join(overrides), flush=True)
    report = vlm_sft_phase("sft_gemma3_4b_cord", GEMMA3_CORD_YAML, overrides,
                           flush, written=written, snap=snap)
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)), ignore_errors=True)
    # the YAML's consolidated save at the last step: the generate phase's
    # export (the caller removes ``work``)
    ckpts = os.path.join(work, "checkpoints")
    saved = sorted(d for d in os.listdir(ckpts) if "_step_" in d)
    check(len(saved) == 1, f"sft_gemma3_4b_cord: checkpoints {saved}")
    report["export_dir"] = os.path.join(ckpts, saved[0], "model")
    report["work_dir"] = work
    return report


# ---------------------------------------------------------------------------
# Qwen2.5-VL (sft_qwen25_vl_3b_rdr, sft_qwen25_vl_video_mock)
# ---------------------------------------------------------------------------
QWEN_RDR_YAML = os.path.join(VLM_YAMLS, "qwen2_5_vl_3b_rdr.yaml")
QWEN_VIDEO_YAML = os.path.join(VLM_YAMLS, "tiny_qwen25_vl_video_mock.yaml")
QWEN25_VL_3B = "Qwen/Qwen2.5-VL-3B-Instruct"
QWEN25_VL_3B_SEED = 29
# the depth the phase runs at for the script's 1200 s limit: 4 of 36 text
# layers and vision blocks 0-7 of 32 (seven window blocks and the full-
# attention block 7); every width kept.  All 36 / 32 ran 200.6 s, 8 / 8
# 66.6 s (development calls, NVIDIA H100 80GB HBM3, 700.00 W)
QWEN25_VL_TEXT_LAYERS = 4
QWEN25_VL_VISION_BLOCKS = 8
# the mock processor at the published patch geometry: the YAML's pinned
# 614,656 px = 56 x 56 patches of 14 px, 784 merged units an image
QWEN25_VL_PROCESSOR = {
    "_target_": "automodel_tpu.datasets.vlm.mock.Qwen2_5_VLProcessor",
    "vocab_size": 151936, "grid": [1, 56, 56], "patch_size": 14}
QWEN_STEPS = {"sft_qwen25_vl_3b_rdr": (1, 2, 1),     # warm-up, timed,
              "sft_qwen25_vl_video_mock": (0, 4, 0)}  # profiled
RDR_ROWS = 64


def qwen25_vl_3b_config(text_layers, vision_blocks):
    """Qwen2.5-VL-3B-Instruct's published config (the text fields nested
    under ``text_config``, the layout both packages read) at
    ``text_layers`` / ``vision_blocks`` (blocks ``0 ..`` with the published
    full-attention blocks among them).  The image / video / vision-start
    ids are the mock processor's 5 / 6 / 12 (published 151,652 / 151,655 /
    151,656): ids, not widths."""
    return dict(
        architectures=["Qwen2_5_VLForConditionalGeneration"],
        model_type="qwen2_5_vl", torch_dtype="bfloat16",
        tie_word_embeddings=True, bos_token_id=151643,
        eos_token_id=151645, vision_start_token_id=5,
        vision_end_token_id=151653, vision_token_id=151654,
        image_token_id=6, video_token_id=12,
        text_config=dict(
            model_type="qwen2_5_vl_text", vocab_size=151936,
            hidden_size=2048, intermediate_size=11008,
            num_hidden_layers=text_layers, num_attention_heads=16,
            num_key_value_heads=2, hidden_act="silu",
            max_position_embeddings=128000, rms_norm_eps=1e-6,
            rope_theta=1000000.0,
            rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
            sliding_window=32768, use_sliding_window=False,
            max_window_layers=70, attention_dropout=0.0,
            tie_word_embeddings=True, torch_dtype="bfloat16"),
        vision_config=dict(
            model_type="qwen2_5_vl", depth=vision_blocks, hidden_act="silu",
            hidden_size=1280, intermediate_size=3420, num_heads=16,
            in_channels=3, patch_size=14, spatial_merge_size=2,
            temporal_patch_size=2, tokens_per_second=2, window_size=112,
            out_hidden_size=2048,
            fullatt_block_indexes=[i for i in (7, 15, 23, 31)
                                   if i < vision_blocks]))


def qwen25_vl_sample(cfg):
    """The Qwen2.5-VL tensors :func:`write_vlm_model` keeps to check the
    load against."""
    L = cfg["text_config"]["num_hidden_layers"]
    V = cfg["vision_config"]["depth"]
    lm, vt = "model.language_model.", "model.visual."
    return {lm + "embed_tokens.weight", lm + "norm.weight",
            lm + "layers.0.self_attn.q_proj.bias",
            lm + f"layers.{L - 1}.mlp.down_proj.weight",
            vt + "patch_embed.proj.weight", vt + "blocks.0.attn.qkv.bias",
            vt + f"blocks.{V - 1}.norm2.weight",
            vt + f"blocks.{V - 1}.mlp.up_proj.weight",
            vt + "merger.ln_q.weight", vt + "merger.mlp.2.bias"}


def qwen_attn_cases():
    """Kernel 9 at the tower's shapes (Qwen2.5-VL-3B: 16 / 16 heads, head
    dim 80, zero-padded to 128 by the wrappers; non-causal): a full-
    attention block over one 56 x 56 frame (3,136 patches), a window block
    over its 49 windows of 64 patches (every slot valid: the segment ids
    of ones the all-true pad mask folds into), and the windows of a 60 x
    60 grid (64 windows, the edge ones with pad slots, segment 0)."""
    import numpy as np

    from automodel_tpu_torch.models.qwen2_5_vl import _grid_layout

    cases = [("qwen25vl_tower_full_d80", 1, 3136, 16, 16, 80, False, None,
              None, None, False)]
    for name, grid in (("qwen25vl_tower_window_d80", (1, 56, 56)),
                       ("qwen25vl_tower_window_pad_60x60_d80",
                        (1, 60, 60))):
        valid = _grid_layout(grid, 2, 112, 14, 80)["valid"]
        cases.append((name, *valid.shape, 16, 16, 80,
                      valid.astype(np.int32), None, None, None, False))
    return cases


def rdr_rows(work, n, seed):
    """``n`` rows in RDR's schema as a local jsonl: ``text`` a product
    description of 20-90 words, ``image`` a local ``.npy`` of a uint8
    image of a random aspect (the YAML squares them to 784 px)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(work, "images"), exist_ok=True)
    rows = []
    for i in range(n):
        h, w = (int(x) for x in rng.integers(400, 1000, 2))
        path = os.path.join(work, "images", f"{i}.npy")
        np.save(path, rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        rows.append({"text": " ".join(rng.choice(WORDS, int(
            rng.integers(20, 90)))), "image": path})
    return write_jsonl(os.path.join(work, "rdr.jsonl"), rows)


def qwen_vl_phase(label, yaml_path, flush, text_case, overrides=(),
                  processor=None, written=None, snap=None, depth_note=None):
    """A Qwen2.5-VL YAML through the port's VLM recipe on the card
    (``recipes/vlm/finetune.py``, what ``automodel-torch finetune vlm``
    runs) with ``overrides`` (and the processor section replaced by
    ``processor``).  Gates: the loaded weights bit for bit as written;
    kernel 9 at the decoder's rows of the first batch against its plain
    version (MaskedCE: no other kernel runs); the first step (the first
    microbatch) through the kernels against every plain version within
    the SFT limits; the exact launch counts over the timed steps (kernel
    9 forward twice per text layer and per vision block and microbatch
    under remat, backward once; the plain attention never); the
    checkpoint the YAML asks for, saved at one more step and read back
    bit for bit.  Reports step time, non-pad tokens/s, images/s, peak
    memory, the losses per step and a profiled window's device / host
    time and idle share."""
    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.recipes.vlm.finetune import FinetuneRecipeForVLM

    warmup, steps, profiled = QWEN_STEPS[label]
    cfg = parse_args_and_load_config(
        ["-c", yaml_path, "--step_scheduler.max_steps", str(warmup or steps),
         *overrides])
    if processor is not None:
        cfg.set_by_dotted("processor", dict(processor))
    t0 = time.perf_counter()
    recipe = FinetuneRecipeForVLM(cfg).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = recipe.model
    tc, vc = model.config.text_config, model.config.vision_config
    check(isinstance(recipe.loss_fn, MaskedCrossEntropy),
          f"{label}: loss {type(recipe.loss_fn).__name__}")
    held = 0
    if written is not None:
        held = loaded_equal(label, model, written)
        check(model.checkpoint_dir == snap,
              f"{label}: the model came from {model.checkpoint_dir}")
    ckpt = recipe.checkpoint_config
    ckpt_on = ckpt.enabled
    ckpt.enabled = False                 # until the last step
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    tower_trained = any(p.requires_grad for p in model.visual.parameters())
    embed_trained = model.language_model.embed_tokens.weight.requires_grad
    print(f"{label}: {type(model).__name__} text (vocab {tc.vocab_size}, "
          f"hidden {tc.hidden_size}, ffn {tc.intermediate_size}, layers "
          f"{tc.num_hidden_layers}, heads {tc.num_attention_heads}/"
          f"{tc.num_key_value_heads}, head_dim {tc.head_dim}, mrope "
          f"{list(model.config.mrope_section)}), vision (hidden "
          f"{vc.hidden_size}, ffn {vc.intermediate_size}, blocks {vc.depth} "
          f"(full attention {list(vc.fullatt_block_indexes)}), heads "
          f"{vc.num_heads}, head_dim {vc.head_dim}, window {vc.window_size}, "
          f"patch {vc.patch_size}, out {vc.out_hidden_size}), image grid "
          f"{model.image_grid}, video grid {model.video_grid}; "
          f"{depth_note or 'depth as written'}; {model.num_params} params "
          f"{model.param_dtype}, {trainable} trainable (vision tower "
          f"{'trained' if tower_trained else 'frozen'}, embeddings "
          f"{'trained' if embed_trained else 'frozen'}), {held} written "
          f"tensors held bit for bit; set up in {setup_s:.1f} s", flush=True)

    first = next(iter(recipe.dataloader))
    B, S = first["input_ids"].shape
    attn_rows = attention_phase(flush, None, [(
        text_case, B, S, tc.num_attention_heads,
        tc.num_key_value_heads, tc.head_dim, False, None, None)])
    torch.cuda.empty_cache()
    first_step = first_step_check(
        recipe, label,
        [("kernel", recipe.loss_fn, "kernel"),
         ("plain", recipe.loss_fn, "plain"),
         ("kernel_again", recipe.loss_fn, "kernel")],
        [("kernel", "plain")], rows=None)

    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    if warmup:
        recipe.run_train_validation_loop()
        recipe.step_scheduler.max_steps += steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0     # zeroed just before the run
    sa.plain_fwd_calls = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = dict(attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                  plain_fwd_calls=sa.plain_fwd_calls)
    peak = torch.cuda.max_memory_allocated()
    del recipe._run_train_optim_step
    check(len(recipe.history) == warmup + steps == len(seen),
          f"{label}: {len(recipe.history)} steps, {len(seen)} groups")
    timed = seen[warmup:]
    micro = sum(len(g) for g in timed)
    # one tower call per microbatch and modality (its images or videos
    # batched); a trained tower (the YAMLs' freeze misses ``visual``) is
    # recomputed under remat and differentiated like the decoder
    tower_calls = sum((mb.get("pixel_values") is not None)
                      + (mb.get("pixel_values_videos") is not None)
                      for g in timed for mb in g)
    text, blocks = tc.num_hidden_layers * micro, vc.depth * tower_calls
    want = dict(attn_fwd=2 * text + (2 if tower_trained else 1) * blocks,
                attn_bwd=text + (blocks if tower_trained else 0),
                plain_fwd_calls=0)
    check(counts == want, f"{label}: launches {counts} != {want} ({micro} "
          f"microbatches, {tower_calls} tower calls)")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
    pad = getattr(recipe.tokenizer, "pad_token_id", 0) or 0
    tokens = sum(int((np.asarray(mb["input_ids"]) != pad).sum())
                 for g in timed for mb in g)
    images = sum(int(np.asarray(mb[k]).any(-1).sum()) for g in timed
                 for mb in g for k in ("image_grid_thw", "video_grid_thw")
                 if k in mb)
    step_s = sum(m["step_time"] for m in recipe.history[warmup:])
    prof = None
    if profiled:
        def more():
            recipe.step_scheduler.max_steps += profiled
            recipe.run_train_validation_loop()

        prof = profile_window(more, profiled, f"{label}_b{B}_s{S}",
                              ("Splash<",))
    report = dict(
        yaml=os.path.relpath(yaml_path, REPO), overrides=list(overrides),
        processor=processor, depth=depth_note, snapshot=snap,
        written_tensors_held=held, setup_s=setup_s, warmup_steps=warmup,
        steps=steps, microbatches_per_step=len(timed[0]),
        shapes=sorted({f"{mb['input_ids'].shape[0]}x"
                       f"{mb['input_ids'].shape[1]}" for g in timed
                       for mb in g}),
        non_pad_tokens=tokens, images=images,
        step_ms=step_s * 1e3 / steps,
        step_ms_each=[m["step_time"] * 1e3
                      for m in recipe.history[warmup:]],
        non_pad_tokens_per_s=tokens / step_s, images_per_s=images / step_s,
        loop_s=loop_s, peak_mem_bytes=peak, launches=counts,
        predicted_launches=want, trainable_params=trainable,
        vision_tower_trained=tower_trained,
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history],
        first_step=dict(loss_rel_err=first_step["kernel_vs_plain"][
            "loss_rel_err"], grad_rel_l2=first_step["kernel_vs_plain"][
            "grad_rel_l2"], grad_rel_l2_floor=first_step[
            "grad_rel_l2_floor"]),
        profile=prof)
    if ckpt_on:
        # the YAML's consolidated save, at one more step, read back
        ckpt.enabled = True
        recipe.step_scheduler.max_steps += 1
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        step = recipe.step_scheduler.step
        saved = [d for d in os.listdir(ckpt.checkpoint_dir)
                 if d.endswith(f"_step_{step}")]
        check(len(saved) == 1, f"{label}: checkpoints "
              f"{os.listdir(ckpt.checkpoint_dir)} at step {step}")
        model_dir = os.path.join(ckpt.checkpoint_dir, saved[0], "model")
        save_s = time.perf_counter() - t0
        back = AutoModelForImageTextToText.from_pretrained(
            model_dir, load_weights=True, device="cuda",
            image_grid=model.image_grid)
        live = {n: t.detach() for n, t, _ in hf_io.hf_tensors(model)}
        read = {n: t.detach() for n, t, _ in hf_io.hf_tensors(back)}
        check(sorted(live) == sorted(read),
              f"{label}: the checkpoint's tensors differ")
        differ = [n for n in live if not torch.equal(live[n], read[n])]
        check(not differ, f"{label}: {differ[:3]} read back differently")
        report["checkpoint"] = dict(
            step=step, tensors=len(live), bytes=sum(
                os.path.getsize(os.path.join(model_dir, f))
                for f in os.listdir(model_dir)),
            save_and_step_s=save_s, bit_identical=True)
        report["export_dir"] = model_dir
        del back, live, read
    print(f"{label}_run " + json.dumps(report), flush=True)
    report["attention_cases"] = attn_rows
    del recipe, model
    gc.collect()
    torch.cuda.empty_cache()
    return report


def qwen25_vl_3b_rdr_phase(hf_home, flush):
    """``qwen2_5_vl_3b_rdr.yaml`` at Qwen2.5-VL-3B-Instruct's published
    widths and ``QWEN25_VL_TEXT_LAYERS`` / ``QWEN25_VL_VISION_BLOCKS``:
    the repo id resolved to an ``HF_HOME`` snapshot of its
    published config with random bf16 weights, the processor section
    replaced by the mock processor at the published patch geometry, local
    jsonl rows in RDR's schema; batch 8 / 1, ``resize_images_to`` 784, the
    freeze config, AdamW with ``mu_dtype`` bfloat16 and ``grad_dtype``
    bfloat16 as written.  The overrides are on the phase's line."""
    work = tempfile.mkdtemp(prefix="chip_smoke_rdr_")
    L, V = QWEN25_VL_TEXT_LAYERS, QWEN25_VL_VISION_BLOCKS
    cfg = qwen25_vl_3b_config(L, V)
    snap, written = write_vlm_model(hf_home, QWEN25_VL_3B, cfg,
                                    QWEN25_VL_3B_SEED,
                                    sample=qwen25_vl_sample, norm_center=1.0)
    overrides = ["--dataset.path_or_dataset", rdr_rows(work, RDR_ROWS, 37),
                 "--checkpoint.checkpoint_dir",
                 os.path.join(work, "checkpoints")]
    depth = (f"{L} of 36 text layers, vision blocks 0-{V - 1} of 32 (full "
             f"attention {cfg['vision_config']['fullatt_block_indexes']}); "
             "image / video / vision-start ids 6 / 12 / 5 (the mock "
             "processor's), every width as published")
    print("sft_qwen25_vl_3b_rdr overrides: " + " ".join(overrides)
          + " processor=" + json.dumps(QWEN25_VL_PROCESSOR) + "; " + depth,
          flush=True)
    report = qwen_vl_phase("sft_qwen25_vl_3b_rdr", QWEN_RDR_YAML, flush,
                           "qwen25vl_text_d128", overrides,
                           processor=QWEN25_VL_PROCESSOR,
                           written=written, snap=snap, depth_note=depth)
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)), ignore_errors=True)
    report["work_dir"] = work          # the caller removes it
    return report


# ---------------------------------------------------------------------------
# Gemma-3n (sft_gemma3n_e4b_medpix, sft_gemma3n_e4b_medpix_peft,
# sft_gemma3n_mock)
# ---------------------------------------------------------------------------
GEMMA3N_MEDPIX_YAML = os.path.join(VLM_YAMLS, "gemma3n_vl_medpix.yaml")
GEMMA3N_PEFT_YAML = os.path.join(VLM_YAMLS, "gemma3n_vl_medpix_peft.yaml")
GEMMA3N_MOCK_YAML = os.path.join(VLM_YAMLS, "tiny_gemma3n_mock.yaml")
GEMMA3N_E4B = "google/gemma-3n-e4b-it"         # the YAMLs' repo id
GEMMA3N_E4B_SEED = 43
# the depth the phases run at: the first 5 of 35 layers (one published
# block: 4 sliding, 1 full; all sparse), every width kept; the whole depth
# (~6.9 B parameters, a per-layer table of 2.35 B) would not fit one card
# with the optimizer's state
GEMMA3N_E4B_LAYERS = 5
# the mock processor at the published image geometry: (768 / 48)^2 = 256
# placeholders, the model's vision_soft_tokens_per_image, at image_token_id
GEMMA3N_PROCESSOR = {
    "_target_": "automodel_tpu.datasets.vlm.mock.MockVLMProcessor",
    "vocab_size": 262400, "image_size": 768, "patch_size": 48,
    "image_token_id": 262145}
GEMMA3N_STEPS = {"sft_gemma3n_e4b_medpix": (1, 2, 1),   # warm-up, timed,
                 "sft_gemma3n_e4b_medpix_peft": (1, 2, 0),   # profiled
                 "sft_gemma3n_mock": (0, 6, 0)}
MEDPIX_ROWS = 48
# the first step's gradient limit in floors (see gemma3n_phase): the
# kernel route no farther from the plain one than the plain one is from
# itself with its attention output rounded the other way.  Measured at
# E4B's widths (NVIDIA H100 80GB HBM3, 700.00 W): that
# floor 54.8 % of the whole gradient, the kernel 42.9 %, the loss 1.1e-4
GEMMA3N_FLOOR_FACTOR = 1.0
# kernel 9 at Gemma-3n-E4B's shapes: GQA 8 / 2 at head_dim 256, softmax
# scale 1.0 (q / k rms-normed per head), window 512 and causal full
GEMMA3N_ATTN_CASES = [
    ("gemma3n_e4b_window512_d256_scale1", 2, 4096, 8, 2, 256, False, 512,
     None, 1.0),
    ("gemma3n_e4b_causal_d256_scale1", 2, 4096, 8, 2, 256, False, None,
     None, 1.0),
]


def gemma3n_e4b_config(layers):
    """google/gemma-3n-E4B-it's published config.json (its text and vision
    fields; the audio tower is not ported) at the first ``layers`` of 35:
    ``layer_types``, ``intermediate_size`` and
    ``activation_sparsity_pattern`` cut to that prefix."""
    L = 35
    return dict(
        architectures=["Gemma3nForConditionalGeneration"],
        model_type="gemma3n", torch_dtype="bfloat16",
        image_token_id=262145, boi_token_id=255999, eoi_token_id=262144,
        eos_token_id=[1, 106], vision_soft_tokens_per_image=256,
        audio_soft_tokens_per_image=188, audio_token_id=262273,
        initializer_range=0.02,
        text_config=dict(
            model_type="gemma3n_text", vocab_size=262400,
            vocab_size_per_layer_input=262144, hidden_size=2048,
            hidden_size_per_layer_input=256,
            intermediate_size=[16384] * L, num_hidden_layers=L,
            num_attention_heads=8, num_key_value_heads=2, head_dim=256,
            laurel_rank=64, altup_num_inputs=4, altup_active_idx=0,
            altup_coef_clip=120.0, altup_correct_scale=True,
            num_kv_shared_layers=15, sliding_window=512,
            rope_theta=1000000.0, rope_local_base_freq=10000.0,
            rope_scaling=None, rms_norm_eps=1e-6,
            max_position_embeddings=32768, final_logit_softcapping=30.0,
            query_pre_attn_scalar=256, hidden_activation="gelu_pytorch_tanh",
            attention_bias=False, attention_dropout=0.0,
            layer_types=["full_attention" if (i + 1) % 5 == 0
                         else "sliding_attention" for i in range(L)],
            activation_sparsity_pattern=[0.95] * 10 + [0.0] * 25,
            torch_dtype="bfloat16"),
        vision_config=dict(
            model_type="gemma3n_vision", architecture="mobilenetv5_300m_enc",
            hidden_size=2048, vocab_size=128, vocab_offset=262144,
            rms_norm_eps=1e-6, do_pooling=False))


def gemma3n_cut(cfg, layers):
    """``cfg`` at its first ``layers`` text layers."""
    cfg = json.loads(json.dumps(cfg))
    tc = cfg["text_config"]
    tc["num_hidden_layers"] = layers
    for key in ("layer_types", "intermediate_size",
                "activation_sparsity_pattern"):
        tc[key] = tc[key][:layers]
    return cfg


def gemma3n_sample(cfg):
    """The Gemma-3n tensors :func:`write_vlm_model` keeps to check the load
    against."""
    L = cfg["text_config"]["num_hidden_layers"]
    lm, vt = "model.language_model.", "model.vision_tower.native."
    return {lm + "embed_tokens.weight", lm + "embed_tokens_per_layer.weight",
            lm + "per_layer_model_projection.weight", lm + "norm.weight",
            lm + "altup_projections.2.weight",
            lm + "altup_unembed_projections.0.weight",
            lm + "layers.0.self_attn.q_norm.weight",
            lm + "layers.0.laurel.linear_left.weight",
            lm + f"layers.{L - 1}.altup.correct_output_scale",
            lm + f"layers.{L - 1}.altup.prediction_coefs.weight",
            lm + f"layers.{L - 1}.mlp.down_proj.weight",
            lm + f"layers.{L - 1}.per_layer_projection.weight",
            "model.embed_vision.embedding.weight",
            "model.embed_vision.embedding_projection.weight",
            vt + "stem.kernel", vt + "blocks.depthwise.kernel",
            vt + "blocks.norm.weight", vt + "head.kernel"}


def medpix_rows(work, n, seed):
    """``n`` rows in MedPix-VQA's schema as a local jsonl: ``question`` of
    6-16 words, ``answer`` of 10-120, ``image`` a local ``.npy`` of a
    uint8 image of a random aspect (the processor resizes to 768 px)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(work, "images"), exist_ok=True)
    rows = []
    for i in range(n):
        h, w = (int(x) for x in rng.integers(400, 1000, 2))
        path = os.path.join(work, "images", f"{i}.npy")
        np.save(path, rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        rows.append({
            "question": " ".join(rng.choice(WORDS, int(rng.integers(6, 17)))),
            "answer": " ".join(rng.choice(WORDS, int(rng.integers(10, 121)))),
            "image": path})
    return write_jsonl(os.path.join(work, "medpix.jsonl"), rows)


def gemma3n_phase(label, yaml_path, flush, overrides=(), processor=None,
                  written=None, snap=None, depth_note=None):
    """A Gemma-3n YAML through the port's VLM recipe on the card
    (``recipes/vlm/finetune.py``, what ``automodel-torch finetune vlm``
    runs) with ``overrides`` (and the processor section replaced by
    ``processor``).  Gates: the loaded weights bit for bit as written;
    kernel 9 at the decoder's rows of the first batch (scale 1.0, window
    ``sliding_window``) against its plain version (MaskedCE: the soft cap
    keeps the fused linear CE away, as in JAX); the first step (the first
    microbatch) through the kernels against every plain version within the
    SFT limits; the exact launch counts over the timed steps (kernel 9
    forward twice per layer and microbatch under remat, backward once; the
    plain attention never); under PEFT the ``peft_checks`` (the base bit
    for bit, adapters saved and read back) and the adapter count against
    the JAX formula over the seven projections; the checkpoint the YAML
    asks for at one more step, read back bit for bit.  Reports step time,
    non-pad tokens/s, images/s, MFU by the work done (text tokens x
    ``flops_per_token`` less what frozen weights skip: the tied head's dW
    when the embeddings are frozen, every dW of the frozen base under
    PEFT; images x the conv tower's ``flops_per_image``, a third of it for
    a frozen tower that runs forward only), peak memory and a profiled
    window's device / host time and idle share."""
    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import dispatched_window
    from automodel_tpu_torch.peft.lora import load_adapters
    from automodel_tpu_torch.recipes.vlm.finetune import FinetuneRecipeForVLM

    warmup, steps, profiled = GEMMA3N_STEPS[label]
    cfg = parse_args_and_load_config(
        ["-c", yaml_path, "--step_scheduler.max_steps", str(warmup or steps),
         *overrides])
    if processor is not None:
        cfg.set_by_dotted("processor", dict(processor))
    t0 = time.perf_counter()
    recipe = FinetuneRecipeForVLM(cfg).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = recipe.model
    peft = recipe.peft_config is not None
    base = model.base_model if peft else model
    tc, vc = base.config.text_config, base.config.vision_config
    lm = base.language_model
    check(isinstance(recipe.loss_fn, MaskedCrossEntropy),
          f"{label}: loss {type(recipe.loss_fn).__name__}")
    held = 0
    if written is not None:
        held = loaded_equal(label, base, written)
        check(base.checkpoint_dir == snap,
              f"{label}: the model came from {base.checkpoint_dir}")
    base_before = ([t.cpu().clone() for t in base.state_dict().values()]
                   if peft else None)
    ckpt = recipe.checkpoint_config
    ckpt_on = ckpt.enabled
    ckpt.enabled = False                 # until the last step
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    tower_trained = any(p.requires_grad
                        for p in base.vision_tower.parameters())
    embed_trained = lm.embed_tokens.weight.requires_grad
    ple_trained = lm.embed_tokens_per_layer.weight.requires_grad
    image_side = int(getattr(recipe.processor, "image_size"))
    sparse = [i for i, l in enumerate(lm.layers) if l.std_mult is not None]
    full = [i for i, l in enumerate(lm.layers) if l.full]
    print(f"{label}: {type(base).__name__} text (vocab {tc.vocab_size}, "
          f"per-layer vocab {tc.vocab_size_per_layer_input} x "
          f"{tc.hidden_size_per_layer_input}, hidden {tc.hidden_size}, ffn "
          f"{tc.intermediate_size}, layers {tc.num_hidden_layers} (full "
          f"{full}, the others window {tc.sliding_window}; sparse gate "
          f"{sparse}), heads {tc.num_attention_heads}/"
          f"{tc.num_key_value_heads}, head_dim {tc.head_dim}, laurel "
          f"{tc.laurel_rank}, altup {tc.altup_num_inputs}, softcap "
          f"{tc.final_logit_softcapping}), vision (native tower: stem "
          f"{vc.stem_channels}, {vc.depth} blocks x{vc.expand_ratio}, hidden "
          f"{vc.hidden_size}, {base.config.vision_soft_tokens_per_image} "
          f"soft tokens, image {image_side} px); "
          f"{depth_note or 'depth as written'}; {base.num_params} params "
          f"{base.param_dtype}, {trainable} trainable (vision tower "
          f"{'trained' if tower_trained else 'frozen'}, embeddings "
          f"{'trained' if embed_trained else 'frozen'}, per-layer table "
          f"{'trained' if ple_trained else 'frozen'}"
          f"{', LoRA merged' if peft and not model.bypass else ''}), "
          f"{held} written tensors held bit for bit; set up in "
          f"{setup_s:.1f} s", flush=True)
    if peft:
        want = lora_trainable_count(tc, recipe.peft_config.dim)
        check(trainable == want == model.num_trainable_params,
              f"{label}: {trainable} trainable, the JAX formula {want}")
        targets = sorted(model.targets)
        check(len(targets) == 7 and all(
            m.startswith("language_model.layers.") for m in targets),
              f"{label}: LoRA targets {targets}")
        print(f"{label} peft_trainable " + json.dumps(dict(
            trainable=trainable, jax_formula=want, targets=targets,
            bypass=model.bypass)), flush=True)

    first = next(iter(recipe.dataloader))
    B, S = first["input_ids"].shape
    win = dispatched_window(tc.sliding_window, S)
    attn_rows = attention_phase(flush, None, [(
        f"{label}_first_batch_{'causal' if win is None else f'w{win}'}"
        f"_d{tc.head_dim}_scale1",
        B, S, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim,
        False, win, None, 1.0)])
    torch.cuda.empty_cache()
    # scale 1.0 over unit-rms q / k rows (norm weights around 1) makes the
    # attention sharp: a row's dS = P (dP - rowsum(dO O)) is then a small
    # difference of two large terms, and the bf16 rounding of O (in the
    # kernel, the plain version and JAX's splash alike) decides much of
    # it.  The whole gradient moves with that rounding alone, so its limit
    # is the larger of the SFT limit and GEMMA3N_FLOOR_FACTOR times that
    # floor (plain against plain with its output nudged one ulp), measured
    # in the same pass; the kernel itself is held to 2e-2 on this batch's
    # rows by the attention case above
    first_step = first_step_check(
        recipe, label,
        [("kernel", recipe.loss_fn, "kernel"),
         ("plain", recipe.loss_fn, "plain"),
         ("kernel_again", recipe.loss_fn, "kernel"),
         ("plain_nudged", recipe.loss_fn, "plain")],
        [("kernel", "plain")], rows=None, floor_route="plain_nudged",
        floor_base="plain", floor_factor=GEMMA3N_FLOOR_FACTOR,
        contexts={"plain_nudged": lambda: plain_attention_nudged(53)})

    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    if warmup:
        recipe.run_train_validation_loop()
        recipe.step_scheduler.max_steps += steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0     # zeroed just before the run
    sa.plain_fwd_calls = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = dict(attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                  plain_fwd_calls=sa.plain_fwd_calls)
    peak = torch.cuda.max_memory_allocated()
    del recipe._run_train_optim_step
    check(len(recipe.history) == warmup + steps == len(seen),
          f"{label}: {len(recipe.history)} steps, {len(seen)} groups")
    timed = seen[warmup:]
    micro = sum(len(g) for g in timed)
    L = tc.num_hidden_layers
    want = dict(attn_fwd=2 * L * micro, attn_bwd=L * micro,
                plain_fwd_calls=0)
    check(counts == want, f"{label}: launches {counts} != {want} ({micro} "
          "microbatches)")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
    pad = getattr(recipe.tokenizer, "pad_token_id", 0) or 0
    tokens = sum(int((np.asarray(mb["input_ids"]) != pad).sum())
                 for g in timed for mb in g)
    rows = sum(int(np.asarray(mb["input_ids"]).size) for g in timed
               for mb in g)
    images = sum(int(np.asarray(mb["pixel_values"]).reshape(
        *mb["pixel_values"].shape[:2], -1).any(-1).sum())
        for g in timed for mb in g)
    step_s = sum(m["step_time"] for m in recipe.history[warmup:])
    tok_s, img_s = tokens / step_s, images / step_s
    fpt, fpi = base.flops_per_token(), base.flops_per_image(image_side)
    if peft:
        fpt_done = fpt * 2.0 / 3.0           # no weight gradient anywhere
    else:
        fpt_done = fpt - (0.0 if embed_trained
                          else 2.0 * tc.vocab_size * tc.hidden_size)
    fpi_done = fpi if tower_trained else fpi / 3.0
    prof = None
    if profiled:
        def more():
            recipe.step_scheduler.max_steps += profiled
            recipe.run_train_validation_loop()

        prof = profile_window(more, profiled, f"{label}_b{B}_s{S}",
                              ("Splash<",))
    report = dict(
        yaml=os.path.relpath(yaml_path, REPO), overrides=list(overrides),
        processor=processor, depth=depth_note, snapshot=snap,
        written_tensors_held=held, setup_s=setup_s, warmup_steps=warmup,
        steps=steps, microbatches_per_step=len(timed[0]),
        shapes=sorted({f"{mb['input_ids'].shape[0]}x"
                       f"{mb['input_ids'].shape[1]}" for g in timed
                       for mb in g}),
        non_pad_tokens=tokens, padded_tokens=rows, images=images,
        step_ms=step_s * 1e3 / steps,
        step_ms_each=[m["step_time"] * 1e3
                      for m in recipe.history[warmup:]],
        non_pad_tokens_per_s=tok_s, images_per_s=img_s,
        flops_per_token=fpt, flops_per_image=fpi,
        flops_per_token_done=fpt_done, flops_per_image_done=fpi_done,
        mfu=(tok_s * fpt_done + img_s * fpi_done) / BF16_OPS_PER_S,
        mfu_padded_rows=(rows / step_s * fpt_done + img_s * fpi_done)
        / BF16_OPS_PER_S,
        loop_s=loop_s, peak_mem_bytes=peak, launches=counts,
        predicted_launches=want, trainable_params=trainable,
        vision_tower_trained=tower_trained, embeddings_trained=embed_trained,
        per_layer_table_trained=ple_trained,
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history],
        first_step=dict(loss_rel_err=first_step["kernel_vs_plain"][
            "loss_rel_err"], grad_rel_l2=first_step["kernel_vs_plain"][
            "grad_rel_l2"], grad_rel_l2_floor=first_step[
            "grad_rel_l2_floor"], grad_tol=first_step["grad_tol"]),
        profile=prof)
    if peft:
        report["peft"] = peft_checks(recipe, label, base_before)
    if ckpt_on:
        # the YAML's save (consolidated weights, or the adapters under
        # PEFT) at one more step, read back
        ckpt.enabled = True
        recipe.step_scheduler.max_steps += 1
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        step = recipe.step_scheduler.step
        saved = [d for d in os.listdir(ckpt.checkpoint_dir)
                 if d.endswith(f"_step_{step}")]
        check(len(saved) == 1, f"{label}: checkpoints "
              f"{os.listdir(ckpt.checkpoint_dir)} at step {step}")
        model_dir = os.path.join(ckpt.checkpoint_dir, saved[0], "model")
        save_s = time.perf_counter() - t0
        if peft:
            live = [p.detach().clone() for p in model.adapters.parameters()]
            with torch.no_grad():
                for p in model.adapters.parameters():
                    p.zero_()
            load_adapters(model, model_dir)
            differ = [i for i, (a, b) in enumerate(zip(
                model.adapters.parameters(), live)) if not torch.equal(a, b)]
            n = len(live)
        else:
            back = AutoModelForImageTextToText.from_pretrained(
                model_dir, load_weights=True, device=recipe.device)
            live = {n: t.detach() for n, t, _ in hf_io.hf_tensors(model)}
            read = {n: t.detach() for n, t, _ in hf_io.hf_tensors(back)}
            check(sorted(live) == sorted(read),
                  f"{label}: the checkpoint's tensors differ")
            differ = [n for n in live if not torch.equal(live[n], read[n])]
            n = len(live)
            del back, read
        check(not differ, f"{label}: {differ[:3]} read back differently")
        report["checkpoint"] = dict(
            step=step, tensors=n, bytes=sum(
                os.path.getsize(os.path.join(model_dir, f))
                for f in os.listdir(model_dir)),
            save_and_step_s=save_s, bit_identical=True)
        del live
    print(f"{label}_run " + json.dumps(report), flush=True)
    report["attention_cases"] = attn_rows
    del recipe, model, base, lm
    gc.collect()
    torch.cuda.empty_cache()
    return report


def gemma3n_phases(hf_home, flush):
    """The two MedPix YAMLs at Gemma-3n-E4B-it's published widths and
    ``GEMMA3N_E4B_LAYERS`` layers (the repo id resolved to an ``HF_HOME``
    snapshot of its published config with random bf16 weights, norms
    around 1: Gemma-3n scales by ``w``), the processor section replaced
    by the mock processor at the published image geometry, local jsonl
    rows in MedPix's schema; batch 8 / 1, the freeze config, the clip,
    AdamW with ``mu_dtype`` bfloat16 and ``grad_dtype`` bfloat16 as
    written; the full fine-tuning YAML with
    ``--checkpoint.save_consolidated true`` (its Orbax save is not
    ported); then ``tiny_gemma3n_mock.yaml`` as written.  The overrides
    are on each phase's line."""
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_medpix_")
    L = GEMMA3N_E4B_LAYERS
    cfg = gemma3n_cut(gemma3n_e4b_config(35), L)
    snap, written = write_vlm_model(hf_home, GEMMA3N_E4B, cfg,
                                    GEMMA3N_E4B_SEED, sample=gemma3n_sample,
                                    norm_center=1.0)
    rows = medpix_rows(work, MEDPIX_ROWS, 47)
    depth = (f"the first {L} of 35 text layers (layer_types, "
             "intermediate_size and activation_sparsity_pattern cut to "
             "that prefix), every width as published")
    runs = {}
    for label, yaml_path, extra in (
            ("sft_gemma3n_e4b_medpix", GEMMA3N_MEDPIX_YAML,
             ["--checkpoint.save_consolidated", "true",
              "--validation_dataset.path_or_dataset", rows]),
            ("sft_gemma3n_e4b_medpix_peft", GEMMA3N_PEFT_YAML, [])):
        overrides = ["--dataset.path_or_dataset", rows, *extra,
                     "--checkpoint.checkpoint_dir",
                     os.path.join(work, label)]
        print(f"{label} overrides: " + " ".join(overrides) + " processor="
              + json.dumps(GEMMA3N_PROCESSOR) + "; " + depth, flush=True)
        torch.cuda.empty_cache()
        runs[label] = gemma3n_phase(label, yaml_path, flush, overrides,
                                    processor=GEMMA3N_PROCESSOR,
                                    written=written, snap=snap,
                                    depth_note=depth)
        shutil.rmtree(os.path.join(work, label), ignore_errors=True)
        phase_done(label)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)), ignore_errors=True)
    torch.cuda.empty_cache()
    runs["sft_gemma3n_mock"] = gemma3n_phase(
        "sft_gemma3n_mock", GEMMA3N_MOCK_YAML, flush)
    phase_done("sft_gemma3n_mock")
    return runs


# ---------------------------------------------------------------------------
# pretraining (pretrain_gpt2_nanogpt), sequence classification
# (sft_seqcls_llama_1b) and the Granite / OLMo-2 / StarCoder-2 / Phi-3
# families (sft_granite, sft_olmo2, sft_starcoder2, sft_phi3)
# ---------------------------------------------------------------------------
NANOGPT_YAML = os.path.join(REPO, "examples", "llm_pretrain",
                            "nanogpt_pretrain.yaml")
# uint16 token shards written with the port's write_shard: seeded tokens
# below GPT-2's 50,257, 510 windows of 1,025 tokens (the 11 steps' 352)
NANOGPT_SHARDS, NANOGPT_SHARD_TOKENS, NANOGPT_SEED = 2, 1 << 18, 41
NANOGPT_WIDTHS = dict(vocab_size=50304, n_positions=1024, n_embd=768,
                      n_layer=12, n_head=12)


def pretrain_gpt2_phase(flush):
    """``examples/llm_pretrain/nanogpt_pretrain.yaml`` as written through
    the SFT recipe (``automodel-torch pretrain llm`` runs the same): GPT-2
    124M at full widths and depth, 8 microbatches of 4 rows a step, the
    fused linear CE, AdamW (weight decay 0.1, betas 0.9 / 0.95), the
    cosine schedule.  Overrides: ``dataset.file_pattern`` (seeded shards
    in a temporary directory), ``step_scheduler.max_steps`` (the phase's
    steps) and ``checkpoint.checkpoint_dir``.  The rows collate to 1,152
    tokens (1,024 and a 128-token pad, labels -100), as in the JAX recipe.
    ``train_phase``'s gates (the first step through every plain version,
    exact launch counts: whole-block remat runs kernel 9's forward twice a
    layer and microbatch), kernel 9 and kernels 2-4 at the phase's shapes,
    and the checkpoint the YAML asks for: saves are held back during the
    timed and profiled steps and one more step runs with them on, whose
    end-of-run safetensors must read back bit for bit."""
    import numpy as np
    import torch

    from automodel_tpu_torch.datasets.llm.nanogpt_dataset import write_shard
    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import AutoModelForCausalLM

    work = tempfile.mkdtemp(prefix="chip_smoke_nanogpt_")
    rng = np.random.default_rng(NANOGPT_SEED)
    for i in range(NANOGPT_SHARDS):
        write_shard(os.path.join(work, f"fineweb_train_{i:06d}.bin"),
                    rng.integers(0, 50257, NANOGPT_SHARD_TOKENS)
                    .astype(np.uint16))
    ckpt_dir = os.path.join(work, "checkpoints")
    overrides = ["--dataset.file_pattern", os.path.join(work, "*.bin"),
                 "--checkpoint.checkpoint_dir", ckpt_dir]
    print("pretrain_gpt2_nanogpt overrides: " + " ".join(overrides),
          flush=True)

    def on_setup(recipe):
        c = recipe.model.config
        got = {k: getattr(c, k) for k in NANOGPT_WIDTHS}
        check(got == NANOGPT_WIDTHS, f"pretrain_gpt2_nanogpt: widths {got}")
        check(recipe.step_scheduler.grad_acc_steps == 8,
              f"pretrain_gpt2_nanogpt: {recipe.step_scheduler.grad_acc_steps}"
              " microbatches a step")
        check(recipe.checkpoint_config.enabled
              and recipe.checkpoint_config.model_save_format == "safetensors",
              "pretrain_gpt2_nanogpt: the YAML's checkpoint is not on")
        recipe.checkpoint_config.enabled = False     # until the last step
        first = next(iter(recipe.dataloader))
        B, S = first["input_ids"].shape
        attn = attention_phase(flush, None, [
            ("gpt2_124m_mha_d64", B, S, c.n_head, c.n_head,
             c.n_embd // c.n_head, False, None, None)])
        lce = lce_case("gpt2_v50304", B * S, c.n_embd, c.vocab_size,
                       "bench", first["labels"], flush, seed=310, parts=True)
        torch.cuda.empty_cache()
        return dict(rows=[B, S], attention_cases=attn, lce_case=lce)

    def on_end(recipe, report):
        recipe.checkpoint_config.enabled = True
        recipe.step_scheduler.max_steps += 1
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        step = recipe.step_scheduler.step
        saved = [d for d in os.listdir(ckpt_dir)
                 if d.endswith(f"_step_{step}")]
        check(len(saved) == 1, f"pretrain_gpt2_nanogpt: checkpoints "
              f"{os.listdir(ckpt_dir)} at step {step}")
        model_dir = os.path.join(ckpt_dir, saved[0], "model")
        back = AutoModelForCausalLM.from_pretrained(
            model_dir, load_weights=True, device="cuda")
        live = {n: t.detach() for n, t, _ in hf_io.hf_tensors(recipe.model)}
        read = {n: t.detach() for n, t, _ in hf_io.hf_tensors(back)}
        check(sorted(live) == sorted(read),
              "pretrain_gpt2_nanogpt: the checkpoint's tensors differ")
        differ = [n for n in live if not torch.equal(live[n], read[n])]
        check(not differ, f"pretrain_gpt2_nanogpt: {differ[:3]} read back "
              "differently")
        ck = dict(step=step, dir=os.path.relpath(model_dir, work),
                  tensors=len(live), bytes=sum(
                      os.path.getsize(os.path.join(model_dir, f))
                      for f in os.listdir(model_dir)),
                  save_and_step_s=time.perf_counter() - t0,
                  bit_identical=True)
        print("pretrain_gpt2_nanogpt_checkpoint " + json.dumps(ck),
              flush=True)
        report["checkpoint"] = ck
        del back, live, read

    report = train_phase("pretrain_gpt2_nanogpt", NANOGPT_YAML, overrides,
                         first_step="all_plain", on_setup=on_setup,
                         on_end=on_end)
    shutil.rmtree(work, ignore_errors=True)
    return report


SEQCLS_YAML = os.path.join(HF_YAMLS, "tiny_llama_seqcls_mock.yaml")
SEQCLS_REPO = "meta-llama/Llama-3.2-1B"
SEQCLS_LAYERS = 4                     # of 16 (see HF_LAYERS)
# the YAML's dataset at Llama-3.2-1B's vocabulary, rows of ~256 tokens
SEQCLS_DATASET = ["--dataset.vocab_size", "128256", "--dataset.mean_len",
                  "256", "--dataset.std_len", "64",
                  "--dataset.max_sentence_len", "511"]
# The classifier's first-step loss is the CE of 2 pooled tokens, with no
# average over thousands of tokens as an SFT loss has: it moves as much
# as each pooled hidden state does, which after 16 random bf16 layers is
# as much as the whole gradient (kernel against plain attention: loss
# 5.67 %, gradient 5.95 % relative, on one H100 80GB HBM3 at 700 W).  So
# both are held to the SFT gradient limit (10 %); a wrong pooling or
# attention mask moves them by O(1).
SEQCLS_FIRST_STEP_LIMITS = (SFT_GRAD_REL_L2, SFT_GRAD_REL_L2)
# warm-up, timed and profiled steps: a step is host-bound (16 layers x 8
# microbatches of 2 short rows, ~31,000 launches), so fewer than the SFT
# phases' for the script's time limit
SEQCLS_WARMUP, SEQCLS_STEPS, SEQCLS_PROFILED = 2, 4, 1


def seqcls_phase(hf_home, flush):
    """``tiny_llama_seqcls_mock.yaml``'s sections with two changes: the
    model is ``build_sequence_classifier(name_or_path=...)`` over
    Llama-3.2-1B's published config (4 of its 16 layers, ``SEQCLS_LAYERS``,
    for the time limit; random bf16 weights
    from a seed written as an ``HF_HOME`` snapshot, a causal-LM directory:
    the ``score`` head is fresh), and the dataset is at V 128,256 with rows
    of mean length 256.  Padded rows (multiples of 128), no packing, one
    label per row under ``MaskedCrossEntropy``.  Gates: the backbone's
    weights as written; kernel 9 at the first batch's rows (padding folded
    into segments) against plain; the first step (2 rows) kernel against
    plain attention within ``SEQCLS_FIRST_STEP_LIMITS``; kernel 9's
    launches exactly (2
    forward and 1 backward a layer and microbatch) and no linear-CE
    launch.  Reports step ms, examples/s, peak memory, a profile."""
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models.sequence_classification import (
        ForSequenceClassification,
    )
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.recipes.llm import train_ft

    label = "sft_seqcls_llama_1b"
    snap, written = write_hf_model(hf_home, SEQCLS_REPO, layers=SEQCLS_LAYERS)
    cfg = parse_args_and_load_config(
        ["-c", SEQCLS_YAML, "--step_scheduler.max_steps",
         str(SEQCLS_WARMUP), *SEQCLS_DATASET])
    cfg.set_by_dotted("model", {
        "_target_": "automodel_tpu.models.auto_model."
                    "build_sequence_classifier",
        "name_or_path": SEQCLS_REPO,
        "num_labels": cfg.get("model.num_labels"),
        "pad_token_id": cfg.get("model.pad_token_id")})
    t0 = time.perf_counter()
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = recipe.model
    check(isinstance(model, ForSequenceClassification)
          and isinstance(recipe.loss_fn, MaskedCrossEntropy),
          f"{label}: {type(model).__name__} with "
          f"{type(recipe.loss_fn).__name__}")
    held = loaded_equal(label, model.backbone, written)
    check(float(model.score.weight.detach().abs().max()) > 0,
          f"{label}: the fresh score head is zero")
    dims = model_dims(model.backbone)
    L = dims["layers"]
    print(f"{label}: {type(model.backbone).__name__} backbone {dims}, "
          f"{SEQCLS_LAYERS} of 16 layers (depth cut for the time limit), "
          f"{model.num_labels} labels, pad {model.pad_token_id}, "
          f"{model.num_params} params {model.param_dtype}, {held} written "
          f"tensors held bit for bit, set up in {setup_s:.1f} s",
          flush=True)
    first = next(iter(recipe.dataloader))
    B, S = first["input_ids"].shape
    attn = attention_phase(flush, first["attention_mask"].astype("int32"), [
        (f"{label}_padded_d{dims['head_dim']}", B, S, dims["heads"],
         dims["kv_heads"], dims["head_dim"], True, None, None)])
    torch.cuda.empty_cache()
    fs = first_step_check(
        recipe, label,
        [("kernel", recipe.loss_fn, "kernel"),
         ("plain", recipe.loss_fn, "plain"),
         ("kernel_again", recipe.loss_fn, "kernel")],
        [("kernel", "plain")], limits=SEQCLS_FIRST_STEP_LIMITS)

    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    recipe.run_train_validation_loop()                   # warm-up steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0     # zeroed just before the run
    lce.fwd_launches = lce.dlogits_launches = lce.dh_launches = 0
    lce.dw_launches = 0
    recipe.step_scheduler.max_steps = SEQCLS_WARMUP + SEQCLS_STEPS
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                  lce_fwd=lce.fwd_launches, dlogits=lce.dlogits_launches,
                  dh=lce.dh_launches, dw=lce.dw_launches)
    peak = torch.cuda.max_memory_allocated()
    del recipe._run_train_optim_step
    groups = seen[SEQCLS_WARMUP:]
    check(len(groups) == SEQCLS_STEPS, f"{label}: {len(groups)} timed groups")
    micro = sum(len(g) for g in groups)
    want = dict(attn_fwd=2 * L * micro, attn_bwd=L * micro, lce_fwd=0,
                dlogits=0, dh=0, dw=0)
    check(counts == want, f"{label}: launches {counts} != {want} ({micro} "
          f"microbatches, {L} layers)")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
    examples = sum(mb["labels"].shape[0] for g in groups for mb in g)
    tokens = sum(int(mb["attention_mask"].sum()) for g in groups for mb in g)
    padded = sum(mb["input_ids"].size for g in groups for mb in g)
    timed = recipe.history[SEQCLS_WARMUP:]
    check(all(m["num_label_tokens"] == 16 for m in timed),
          f"{label}: label counts {[m['num_label_tokens'] for m in timed]}")

    def more():
        recipe.step_scheduler.max_steps += SEQCLS_PROFILED
        recipe.run_train_validation_loop()

    prof = profile_window(more, SEQCLS_PROFILED, f"{label}_b{B}",
                          ("Splash<",))
    report = dict(
        yaml=os.path.relpath(SEQCLS_YAML, REPO), model=SEQCLS_REPO,
        snapshot=snap, written_tensors_held=held, setup_s=setup_s,
        dataset_overrides=SEQCLS_DATASET, steps=SEQCLS_STEPS,
        microbatches=micro, examples=examples,
        shapes=[sorted({f"{mb['input_ids'].shape[0]}x"
                        f"{mb['input_ids'].shape[1]}" for mb in g})
                for g in groups],
        nonpad_tokens=tokens, padded_tokens=padded, wall_s=wall,
        step_ms=wall * 1e3 / SEQCLS_STEPS, examples_per_s=examples / wall,
        nonpad_tokens_per_s=tokens / wall, peak_mem_bytes=peak,
        launches=counts, losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history],
        first_step=dict(loss_rel_err=fs["kernel_vs_plain"]["loss_rel_err"],
                        grad_rel_l2=fs["kernel_vs_plain"]["grad_rel_l2"]),
        profile=prof)
    print(f"{label}_run " + json.dumps(report), flush=True)
    report["attention_cases"] = attn
    del recipe, model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)), ignore_errors=True)
    return report


# The published config.json of each family's model (every key HF writes;
# the port reads the ones it knows), written as an HF_HOME snapshot with
# its depth cut to FAMILY_LAYERS; the SFT recipe loads it through
# from_pretrained with the bench YAML's other sections.
FAMILY_CONFIGS = {
    "ibm-granite/granite-3.0-2b-instruct": dict(
        architectures=["GraniteForCausalLM"], attention_bias=False,
        attention_dropout=0.1, attention_multiplier=0.015625,
        bos_token_id=0, embedding_multiplier=12.0, eos_token_id=0,
        hidden_act="silu", hidden_size=2048, initializer_range=0.02,
        intermediate_size=8192, logits_scaling=8.0,
        max_position_embeddings=4096, mlp_bias=False, model_type="granite",
        num_attention_heads=32, num_hidden_layers=40, num_key_value_heads=8,
        pad_token_id=0, residual_multiplier=0.22, rms_norm_eps=1e-05,
        rope_scaling=None, rope_theta=10000.0, tie_word_embeddings=True,
        torch_dtype="bfloat16", transformers_version="4.46.0.dev0",
        use_cache=True, vocab_size=49155),
    "allenai/OLMo-2-1124-7B": dict(
        architectures=["Olmo2ForCausalLM"], attention_bias=False,
        attention_dropout=0.0, eos_token_id=100257, hidden_act="silu",
        hidden_size=4096, initializer_range=0.02, intermediate_size=11008,
        max_position_embeddings=4096, model_type="olmo2",
        num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=32,
        pad_token_id=100277, rms_norm_eps=1e-06, rope_scaling=None,
        rope_theta=500000, tie_word_embeddings=False, torch_dtype="float32",
        transformers_version="4.47.0.dev0", use_cache=True,
        vocab_size=100352),
    "bigcode/starcoder2-3b": dict(
        architectures=["Starcoder2ForCausalLM"], attention_dropout=0.1,
        residual_dropout=0.1, embedding_dropout=0.1, bos_token_id=0,
        eos_token_id=0, hidden_act="gelu_pytorch_tanh", hidden_size=3072,
        initializer_range=0.018042, intermediate_size=12288,
        max_position_embeddings=16384, mlp_type="default",
        model_type="starcoder2", norm_epsilon=1e-05, norm_type="layer_norm",
        num_attention_heads=24, num_hidden_layers=30, num_key_value_heads=2,
        rope_theta=999999.4420358813, sliding_window=4096,
        torch_dtype="bfloat16", transformers_version="4.37.0.dev0",
        use_bias=True, use_cache=True, vocab_size=49152),
    "microsoft/phi-4": dict(
        architectures=["Phi3ForCausalLM"], attention_bias=False,
        attention_dropout=0.0, bos_token_id=100257, embd_pdrop=0.0,
        eos_token_id=100265, hidden_act="silu", hidden_size=5120,
        initializer_range=0.02, intermediate_size=17920,
        max_position_embeddings=16384, model_type="phi3",
        num_attention_heads=40, num_hidden_layers=40, num_key_value_heads=10,
        original_max_position_embeddings=16384, pad_token_id=100349,
        resid_pdrop=0.0, rms_norm_eps=1e-05, rope_scaling=None,
        rope_theta=250000, sliding_window=None, tie_word_embeddings=False,
        torch_dtype="bfloat16", transformers_version="4.47.0",
        use_cache=True, vocab_size=100352),
}
FAMILY_SEEDS = {"ibm-granite/granite-3.0-2b-instruct": 61,
                "allenai/OLMo-2-1124-7B": 62, "bigcode/starcoder2-3b": 63,
                "microsoft/phi-4": 64}
FAMILY_LAYERS = 2
# StarCoder-2 in rows of 8,192 holding documents of ~6,144 tokens, so its
# 4,096-key window cuts into them (2 rows a step: the bench's 16,384
# tokens)
STARCODER2_ROWS = ["--packed_sequence.packed_sequence_size", "8192",
                   "--step_scheduler.global_batch_size", "2",
                   "--step_scheduler.local_batch_size", "2",
                   "--dataset.num_sentences", "64",
                   "--dataset.mean_len", "6144", "--dataset.std_len", "1024",
                   "--dataset.max_sentence_len", "8191"]
FAMILY_PHASES = [
    # (label, repo id, overrides, first-step routes)
    ("sft_granite", "ibm-granite/granite-3.0-2b-instruct", (), "all_plain"),
    ("sft_olmo2", "allenai/OLMo-2-1124-7B", (), "all_plain"),
    # rows of 8,192: the plain attention's [2, 24, 8192, 8192] scores per
    # layer are left out of the first step (the attention case holds
    # kernel 9 against plain on one such row)
    ("sft_starcoder2", "bigcode/starcoder2-3b", STARCODER2_ROWS, None),
    ("sft_phi3", "microsoft/phi-4", (), "all_plain"),
]
# kernel 9 at Phi-3.5-mini's attention (3,072 / 32 heads: D 96, run
# zero-padded to 128) and at Granite-3.0-2B's (32 / 8 at 64, its
# attention_multiplier as the scale) on the bench YAML's packing
FAMILY_ATTN_CASES = [
    ("phi3_5_mini_packed_d96", 8, 2048, 32, 32, 96, True, None, None),
    ("granite_2b_packed_d64_scale", 8, 2048, 32, 8, 64, True, None, None,
     0.015625),
]


def family_yaml(repo_id, work):
    """The bench YAML with its model built by ``from_pretrained`` of
    ``repo_id`` (written to ``work``)."""
    import yaml

    with open(BENCH_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = {"_target_": "automodel_tpu.models.auto_model."
                                "AutoModelForCausalLM.from_pretrained",
                    "pretrained_model_name_or_path": repo_id}
    path = os.path.join(work, repo_id.replace("/", "--") + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def family_sft_phase(label, repo_id, overrides, first_step, hf_home, flush):
    """The SFT recipe over ``repo_id``'s published config at
    ``FAMILY_LAYERS`` layers (random bf16 weights from a seed, an
    ``HF_HOME`` snapshot; OLMo-2's published float32), loaded by
    ``from_pretrained`` with the bench YAML's fused linear CE, packing and
    optimizer: ``train_phase``'s gates, after which the loaded weights
    must equal the written ones bit for bit (every tensor but the second
    layer's), and kernel 9 (the model's heads, scale and window, on the
    first batch's packing; one row at StarCoder-2's 8,192) and kernels 2-4
    (the model's vocabulary, Granite's divisor folded into the head) on
    this path's shapes against plain."""
    import torch

    work = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    snap, written = write_hf_model(
        hf_home, repo_id, layers=FAMILY_LAYERS,
        hold=lambda n: ".layers.1." not in n)
    yaml_path = family_yaml(repo_id, work)

    def on_setup(recipe):
        model = recipe.model
        held = loaded_equal(label, model, written)
        check(model.checkpoint_dir == snap,
              f"{label}: the model came from {model.checkpoint_dir}")
        d = model_dims(model)
        first = next(iter(recipe.dataloader))
        B, S = first["input_ids"].shape
        rows = 1 if S > 4096 else B
        attn = attention_phase(flush, first["segment_ids"], [
            (f"{label}_d{d['head_dim']}", rows, S, d["heads"], d["kv_heads"],
             d["head_dim"], True, model.sliding_window, None,
             model._attn_softmax_scale)])
        lce = lce_case(f"{label}_v{d['vocab']}", B * S, d["hidden"],
                       d["vocab"], "bench", first["labels"], flush,
                       seed=320 + FAMILY_SEEDS[repo_id], parts=True,
                       head_divisor=model._logits_divisor)
        torch.cuda.empty_cache()
        info = dict(repo_id=repo_id, snapshot=snap, layers=FAMILY_LAYERS,
                    published_layers=FAMILY_CONFIGS[repo_id][
                        "num_hidden_layers"], written_tensors_held=held,
                    model_type=model.config.model_type,
                    param_dtype=str(model.param_dtype))
        print(f"{label}_hf_model " + json.dumps(info), flush=True)
        return dict(hf_model=info, attention_cases=attn, lce_case=lce)

    report = train_phase(label, yaml_path, overrides, first_step=first_step,
                         on_setup=on_setup)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)), ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# post-training phases (grpo_llama_1b, dpo_llama_1b)
# ---------------------------------------------------------------------------
GRPO_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "llama3_2_1b_grpo.yaml")
DPO_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                        "llama3_2_1b_dpo.yaml")
PT_WARM, PT_TIMED, PT_PROFILED = 1, 3, 1
LLAMA_VOCAB = 128256
# The first-step check's data terms (GRPO's behaviour and reference
# logprobs, DPO's reference sums) are the plain reference pass's values
# plus a seeded offset, the same on every route: at the recipe's own first
# step the policy is the reference, so ratio, KL and margins sit at 1, 0
# and 0 and say nothing of the kernels.  The behaviour offset keeps every
# ratio well inside GRPO's clip band: a token near the band's edge takes
# the clipped branch on one route and not on the other (the routes'
# logprobs differ by up to ~0.1 in bf16), and each such flip moves the
# gradient by a whole term (offsets of 0.5 made kernel and plain 13 %
# apart, measured on one H100).  The behaviour terms are also shifted by
# -PT_ADV_SHIFT x the row's advantage, so every ratio is ~exp(0.05 A) and
# pg_loss ~ -0.05 mean(A^2) is a value of its own: with ratios at 1 it is
# a mean of terms that cancel (advantages have mean 0 in each group), and
# its value is rounding noise.  The whole gradient is held to the SFT
# gradient limit and the logprobs (relative L2 over the supervised
# positions) to the SFT loss limit.  Each metric M (loss, pg_loss, kl,
# mean_ratio; loss and margin) is held to the tighter of the SFT phases'
# limit (1 % of max(|M plain|, 1)) and 1 % of |M plain| plus
# PT_SPREAD_SIGMAS x its first-order spread: with g_t = dM/dlp_t
# at the plain logprobs and d_t the measured kernel-minus-plain logprob of
# the check's own logprob pass, each sequence (GRPO) or pair (DPO) moves M
# by X_b = sum_t g_t d_t, and the spread is sqrt(sum_b X_b^2), the
# standard deviation of sum_b X_b if the X_b take random signs.  The SFT
# limit alone cannot hold a metric well below 1 (GRPO's loss is ~0.007
# with ratios at 1, its kernel and plain values 5e-4 apart, measured on
# one H100).
PT_BEHAVIOR_OFFSET = 0.02
PT_ADV_SHIFT = 0.05
PT_SPREAD_SIGMAS = 4.0
PT_REF_OFFSET = 0.5
PT_SUM_OFFSET = 10.0
PT_CHECK_SEED = 31
# The prefix-cache gates.  Token identity with caching on and off rests
# on batch invariance, a row's bits the same whatever the step's width:
# attention widths of at most 8 keep decode's key split and every GEMM
# has at most 64 rows (cuBLAS bf16 keeps a row's bits from 8 to 64 rows,
# not at 256).  The exact gate runs two groups of the rollout's prompts
# through 8 slots and chunks of 8, where both hold.  The recipe's engine
# (64 slots, prefill chunks of 128 on the plain gather) has neither: a
# forked member recomputes its last prompt token in a decode step, the
# unforked one in the 8,192-row prefill step, and their tokens part (at
# token 8 of a member, measured on one H100).  There, as for generate()
# (the dense path's plain attention and shapes round otherwise than the
# engine's kernel), a row may part from the other run only where the two
# tokens' logits of the post-step model are within PT_TIE_REL of the
# logit range: the widest such gap measured on one H100 was 0.109 of a
# range of 7.67 (0.0143).
PT_FORK_SERVING = dict(max_num_seqs=8, prefill_chunk=8)
PT_FORK_PROMPTS, PT_FORK_NEW_TOKENS = 2, 16
# the depth GRPO and DPO run at for the script's 1200 s limit (the YAMLs'
# 16; every width as written; see HF_LAYERS)
PT_LAYERS = 8
PT_TIE_REL = 0.02
# DPO accuracy: a pair whose plain margin is within this of 0 may take
# either sign on another route (its margin's rounding noise)
PT_MARGIN_BAND = 0.1


# kernel 9 at the post-training passes' rows: GRPO's 64 and DPO's 32 (per
# half) causal rows of 256, Llama-3.2-1B's 32 / 8 heads of 64
PT_ATTN_CASES = [
    ("grpo_rows_64x256_causal", 64, 256, 32, 8, 64, False, None, None),
    ("dpo_rows_32x256_causal", 32, 256, 32, 8, 64, False, None, None),
]


def lower_vocab_share(prompt, completion):
    """The card phase's GRPO reward (``rl.reward_source: callable``): the
    share of the completion's tokens in the lower half of the vocabulary.
    With random weights over 128,256 tokens eos almost never comes, so the
    length reward would give every completion of a group the same value."""
    return sum(t < LLAMA_VOCAB // 2 for t in completion) / max(
        len(completion), 1)


def _zero_launch_counts():
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops import splash_attention as sa

    sa.fwd_launches = sa.bwd_launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    lce.fwd_launches = lce.dlogits_launches = lce.dh_launches = 0
    lce.dw_launches = 0
    gk.gmm_launches = gk.tgmm_launches = 0
    qk.qdot_launches = gq.gmm_quant_launches = 0
    pak.launches = 0
    tpa.long_q_gather_calls = 0


def _launch_counts():
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops import splash_attention as sa

    return dict(paged_decode=pak.launches,
                long_q_gather=tpa.long_q_gather_calls,
                attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                flash_fwd=fa.fwd_launches, flash_bwd=fa.bwd_launches,
                lce_fwd=lce.fwd_launches, dlogits=lce.dlogits_launches,
                dh=lce.dh_launches, dw=lce.dw_launches,
                gmm=gk.gmm_launches, tgmm=gk.tgmm_launches,
                gmm_quant=gq.gmm_quant_launches, qdot=qk.qdot_launches)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def pt_first_step(label, recipe, batch, objective, metric_keys, lp_batches,
                  metrics_of):
    """The first step's loss, metrics and whole gradient on one fixed batch
    (the recipe's initial weights; nothing is updated) through every
    kernel (``kernel``, twice) and every plain version (``plain``: the
    linear-CE route's and the attention's), and the logprobs of
    ``lp_batches`` through both; the limits are in ``PT_REF_OFFSET``'s
    note.  ``metrics_of({half: logprobs [B, S]})`` gives the metrics from
    logprobs (the first-order spread's derivatives).  ``attn_plain`` (the
    attention alone through its plain version) shows how far the
    attention's rounding alone moves the gradient."""
    import torch

    from automodel_tpu_torch.post_training.logprobs import build_logprob_fn

    model = recipe.model
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    routes = (("kernel", None, None), ("plain", "plain", "plain"),
              ("kernel_again", None, None), ("attn_plain", None, "plain"))
    vals, grads = {}, {}
    for name, impl, attn in routes:
        model.zero_grad(set_to_none=True)
        loss, m = objective(model, batch, impl=impl, attn_impl=attn)
        loss.backward()
        torch.cuda.synchronize()
        vals[name] = {k: float(m[k]) for k in metric_keys}
        grads[name] = [p.grad for _, p in trained]
        check(all(bool(torch.isfinite(g).all()) for g in grads[name]),
              f"{label} first step ({name}): non-finite gradient")
    model.zero_grad(set_to_none=True)

    def grad_rel(a, b, worst=False):
        per = [(float((x.float() - y.float()).square().sum()),
                float(y.float().square().sum()), n)
               for (n, _), x, y in zip(trained, grads[a], grads[b])]
        rel = (sum(d for d, _, _ in per) / sum(w for _, w, _ in per)) ** 0.5
        if not worst:
            return rel
        return rel, [dict(name=n, rel_l2=(d / max(w, 1e-30)) ** 0.5)
                     for d, w, n in sorted(
                         per, key=lambda t: -t[0] / max(t[1], 1e-30))[:3]]

    lp, lps = {}, {}
    for half, b in lp_batches.items():
        got = build_logprob_fn()(model, b)
        want = build_logprob_fn(impl="plain", attn_impl="plain")(model, b)
        sup = b["labels"] != -100
        lp[half] = dict(rel_l2=_rel_l2(got[sup], want[sup]),
                        max_abs_err=float((got - want).abs().max()),
                        mean_logprob=float(want[sup].mean()))
        lps[half] = (got, want)
    # each metric's limit: 1 % of it plus its first-order spread
    leaves = {h: w.clone().requires_grad_() for h, (_, w) in lps.items()}
    of_plain = metrics_of(leaves)
    held = {}
    for k in metric_keys:
        if k == "accuracy":
            continue          # held by its margins (dpo_llama_1b)
        gs = (torch.autograd.grad(of_plain[k], list(leaves.values()),
                                  retain_graph=True, allow_unused=True,
                                  materialize_grads=True)
              if of_plain[k].requires_grad
              else [torch.zeros_like(x) for x in leaves.values()])
        X = sum((g * (lps[h][0] - lps[h][1])).sum(dim=-1)
                for g, h in zip(gs, leaves))
        a, b = vals["kernel"][k], vals["plain"][k]
        spread = float(X.square().sum().sqrt())
        held[k] = dict(diff=a - b, first_order=float(X.sum()),
                       spread=spread,
                       limit=min(SFT_LOSS_REL_TOL * max(abs(b), 1.0),
                                 SFT_LOSS_REL_TOL * abs(b)
                                 + PT_SPREAD_SIGMAS * spread))
    del leaves, of_plain, lps
    rel, worst = grad_rel("kernel", "plain", worst=True)
    out = dict(
        values=vals, grad_rel_l2=rel, worst_params=worst,
        grad_rel_l2_attn_plain=grad_rel("attn_plain", "kernel"),
        grad_rel_l2_kernel_vs_kernel=grad_rel("kernel_again", "kernel"),
        bit_identical_kernel_vs_kernel=vals["kernel"] == vals["kernel_again"]
        and all(torch.equal(x, y) for x, y in zip(grads["kernel"],
                                                  grads["kernel_again"])),
        logprobs=lp, metrics_held=held, metric_rel_tol=SFT_LOSS_REL_TOL,
        spread_sigmas=PT_SPREAD_SIGMAS, grad_tol=SFT_GRAD_REL_L2,
        logprob_tol=SFT_LOSS_REL_TOL)
    del grads
    torch.cuda.empty_cache()
    print(f"{label} first step: " + json.dumps(out), flush=True)
    check(out["grad_rel_l2"] <= SFT_GRAD_REL_L2,
          f"{label} first-step gradient kernel vs plain: relative L2 "
          f"{out['grad_rel_l2']:.3e} > {SFT_GRAD_REL_L2}")
    for half, r in lp.items():
        check(r["rel_l2"] <= SFT_LOSS_REL_TOL,
              f"{label} first-step logprobs ({half}) kernel vs plain: "
              f"relative L2 {r['rel_l2']:.3e} > {SFT_LOSS_REL_TOL}")
    for k, r in held.items():
        check(abs(r["diff"]) <= r["limit"],
              f"{label} first-step {k}: kernel {vals['kernel'][k]} vs plain "
              f"{vals['plain'][k]}, {r['diff']:.3e} apart > {r['limit']:.3e}"
              f" (spread {r['spread']:.3e})")
    return out


def _first_divergence(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _near_tie_rows(label, what, model, prompts, a, b, device):
    """Row by row, ``a`` against ``b`` (completions of ``prompts``): each
    row identical, or parting at a token where the two tokens' logits of
    ``model`` are within ``PT_TIE_REL`` of the logit range."""
    import torch

    rows = []
    for r, (p, x, y) in enumerate(zip(prompts, a, b)):
        y = y[:len(x)]
        j = _first_divergence(x, y)
        row = dict(row=r, identical=j is None, tokens=len(x))
        if j is not None:
            with torch.no_grad():
                ids = torch.tensor([list(p) + list(x[:j])], device=device)
                logits = model(ids)["logits"][0, -1].float()
            gap = abs(float(logits[x[j]] - logits[y[j]]))
            span = float(logits.max() - logits.min())
            row.update(parts_at=j, logit_gap=gap, logit_range=span)
            check(gap <= PT_TIE_REL * span,
                  f"{label}: {what} part at row {r} token {j} where the "
                  f"post-step logits differ by {gap:.4f} (> {PT_TIE_REL} of "
                  f"their range {span:.3f})")
        rows.append(row)
    return rows


def grpo_handoff(label, recipe):
    """After a step: the engine still holds the weights of the last sync
    (the reference's, the initial ones) and not the trainer's; a sync
    makes them the trainer's bit for bit; a temperature-0 rollout of the
    synced engine is token-identical to a fresh engine's on a copy of the
    post-step weights; with prefix caching on and off, a temperature-0
    rollout of the synced weights at the batch-invariant geometry
    (``PT_FORK_SERVING``) is token-identical (the prefill tokens the group
    forks saved printed); at the recipe's own geometry, the rollout with
    prefix caching on and ``generate()`` on the post-step weights give
    the synced engine's tokens up to near-ties (``PT_TIE_REL``), with the
    rows that match exactly counted."""
    import torch

    from automodel_tpu_torch.generation import generate
    from automodel_tpu_torch.post_training.base import PostTrainingRecipeBase
    from automodel_tpu_torch.post_training.rollout import RolloutWorker
    from automodel_tpu_torch.serving import DecodeEngine

    eng, model, rc = recipe.engine, recipe.model, recipe.rollout_config
    own = eng.model.state_dict()
    pol = model.state_dict()
    ref = recipe.ref_model.state_dict()
    check(all(torch.equal(own[k], ref[k]) for k in own),
          f"{label}: after a step the engine does not hold the weights of "
          "its last sync")
    moved = sum(not torch.equal(own[k], pol[k]) for k in own)
    check(moved > 0, f"{label}: the step changed no tensor the engine holds")
    sync_s = recipe.rollout_worker.sync_weights(model)
    check(all(torch.equal(own[k], pol[k]) for k in own),
          f"{label}: after a sync the engine's weights are not the "
          "trainer's")
    greedy = dataclasses.replace(eng.generation, do_sample=False)
    saved_gen, eng.generation = eng.generation, greedy
    prompts = recipe._prompts[:rc.rollout_batch_size]
    G = rc.group_size
    check((recipe.serving_config.prefix_caching or "off") == "off",
          f"{label}: the recipe's engine runs with prefix caching on")
    try:
        synced = RolloutWorker(eng, rc).generate(prompts)
        fresh_eng = DecodeEngine(PostTrainingRecipeBase._frozen_copy(model),
                                 recipe.serving_config, generation=greedy,
                                 device=recipe.device)
        fresh = RolloutWorker(fresh_eng, rc).generate(prompts)
        del fresh_eng
        torch.cuda.empty_cache()
        _identical(f"{label} handoff: synced engine vs a fresh engine on "
                   "the post-step weights", synced.completions,
                   fresh.completions)
        # the exact prefix gate at the batch-invariant geometry (PT_FORK_*)
        fork_rc = dataclasses.replace(
            rc, rollout_batch_size=PT_FORK_PROMPTS,
            max_new_tokens=PT_FORK_NEW_TOKENS)
        fork = {}
        for mode in ("off", "on"):
            f_eng = DecodeEngine(eng.model, dataclasses.replace(
                recipe.serving_config, prefix_caching=mode,
                **PT_FORK_SERVING), generation=greedy, device=recipe.device)
            fork[mode] = (RolloutWorker(f_eng, fork_rc).generate(
                prompts[:PT_FORK_PROMPTS]), f_eng.stats())
            del f_eng
        _identical(f"{label} prefix cache on vs off",
                   fork["on"][0].completions, fork["off"][0].completions)
        on, on_stats = fork["on"]
        # prefix caching on at the recipe's geometry; off is `synced`
        r_eng = DecodeEngine(eng.model, dataclasses.replace(
            recipe.serving_config, prefix_caching="on"), generation=greedy,
            device=recipe.device)
        r_on = RolloutWorker(r_eng, rc).generate(prompts)
        r_stats = r_eng.stats()
        del r_eng
    finally:
        eng.generation = saved_gen
    torch.cuda.empty_cache()
    row_prompts = [p for p in prompts for _ in range(G)]
    r_rows = _near_tie_rows(label, "prefix cache on and off (recipe "
                            "geometry)", model, row_prompts,
                            r_on.completions, synced.completions,
                            recipe.device)
    # generate() on the post-step weights, one row per prompt
    P = max(len(p) for p in prompts)
    ids = torch.zeros(len(prompts), P, dtype=torch.long)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = torch.tensor(p)
    lens = [len(p) for p in prompts]
    dense = [[int(t) for t in row]
             for row in generate(model, ids.numpy(), lens, greedy)]
    g_rows = _near_tie_rows(label, "generate() and the synced engine",
                            model, prompts,
                            [synced.completions[b * G]
                             for b in range(len(prompts))],
                            dense, recipe.device)
    gaps = [r["logit_gap"] / r["logit_range"] for r in r_rows + g_rows
            if not r["identical"]]
    out = dict(sync_ms=sync_s * 1e3, tensors_moved_by_the_step=moved,
               tensors=len(own),
               greedy_rollout_rows=len(synced.completions),
               greedy_new_tokens=rc.max_new_tokens,
               fresh_engine_identical=True, prefix_on_vs_off_identical=True,
               prefix_gate=dict(PT_FORK_SERVING, prompts=PT_FORK_PROMPTS,
                                group_size=G,
                                new_tokens=PT_FORK_NEW_TOKENS),
               prefix_on_prefill_tokens_saved=on.stats[
                   "prefill_tokens_saved"],
               prefix_on_cache_hit_rate=on.stats["cache_hit_rate"],
               prefix_on_cow_forks=on_stats["prefix_cache"]["cow_forks"],
               recipe_geometry_prefix=dict(
                   max_num_seqs=recipe.serving_config.max_num_seqs,
                   prefill_chunk=recipe.serving_config.prefill_chunk,
                   rows=len(r_rows),
                   rows_identical=sum(r["identical"] for r in r_rows),
                   prefill_tokens_saved=r_on.stats["prefill_tokens_saved"],
                   cache_hit_rate=r_on.stats["cache_hit_rate"],
                   cow_forks=r_stats["prefix_cache"]["cow_forks"],
                   parted=[r for r in r_rows if not r["identical"]]),
               tie_rel_limit=PT_TIE_REL,
               widest_tie_rel=max(gaps, default=0.0),
               generate_rows_identical=sum(r["identical"] for r in g_rows),
               generate_rows=g_rows)
    print(f"{label} handoff " + json.dumps(out), flush=True)
    return out


def post_train_phase(label, yaml_path):
    """GRPO (``grpo_llama_1b``) or DPO (``dpo_llama_1b``) on Llama-3.2-1B
    at its published widths through the recipe's ``setup()`` and
    ``run_post_training_loop()`` on the YAML as written but for its depth
    (``PT_LAYERS`` of 16; GRPO with the ``lower_vocab_share`` reward): the
    first step on one fixed batch (for
    GRPO the first rollout's) against every plain version
    (:func:`pt_first_step`), for GRPO the handoff gates
    (:func:`grpo_handoff`) after the warm-up step, then the timed steps
    with every launch count zeroed just before and read just after, held
    to the counts the geometry gives, and a profiled step."""
    import functools

    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.post_training import steps as pst
    from automodel_tpu_torch.post_training.logprobs import (
        batch_to_device,
        build_logprob_fn,
        make_sequence_batch,
    )
    from automodel_tpu_torch.post_training.losses import (
        dpo_losses,
        group_normalized_advantages,
        grpo_token_objective,
    )
    from automodel_tpu_torch.post_training.rollout import compute_rewards
    from automodel_tpu_torch.recipes.llm import train_dpo, train_grpo

    grpo = label.startswith("grpo")
    cfg = parse_args_and_load_config(
        ["-c", yaml_path, "--model.config.num_hidden_layers",
         str(PT_LAYERS)])
    if grpo:
        cfg.set_by_dotted("rl.reward_source", "callable")
        cfg.set_by_dotted("rl.reward_fn", lower_vocab_share)
    cls = (train_grpo.GRPORecipeForCausalLM if grpo
           else train_dpo.DPORecipeForCausalLM)
    t0 = time.perf_counter()
    recipe = cls(cfg).setup()
    torch.cuda.synchronize()
    model, rc, dev = recipe.model, recipe.rollout_config, recipe.device
    mcfg = model.config
    L = mcfg.num_hidden_layers
    print(f"{label}: {type(recipe).__name__} on "
          f"{os.path.relpath(yaml_path, REPO)}"
          + (" with rl.reward_source callable, rl.reward_fn "
             "chip_smoke.lower_vocab_share" if grpo else "")
          + f"; widths (vocab {mcfg.vocab_size}, hidden {mcfg.hidden_size}, "
          f"ffn {mcfg.intermediate_size}, layers {L} of 16 (depth cut for "
          f"the time limit), heads "
          f"{mcfg.num_attention_heads}/{mcfg.num_key_value_heads}, head_dim "
          f"{mcfg.head_dim}), {sum(p.numel() for p in model.parameters())} "
          f"params {model.param_dtype}, compute {model.compute_dtype}; "
          f"set up in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated()} bytes allocated", flush=True)

    # one fixed batch with its data terms (PT_REF_OFFSET)
    g = torch.Generator(device=dev).manual_seed(PT_CHECK_SEED)
    plain_lp = build_logprob_fn(impl="plain", attn_impl="plain")
    if grpo:
        rb = recipe.rollout_worker.generate(
            recipe._prompts[:rc.rollout_batch_size], params=model)
        compute_rewards(rb, rc)
        batch = batch_to_device(make_sequence_batch(
            rb.sequences, rb.prompt_lens, pad_id=rc.pad_token_id,
            pad_to=rc.sequence_length), dev)
        batch["advantages"] = group_normalized_advantages(
            rb.rewards, rc.group_size).to(dev)
        base = plain_lp(recipe.ref_model, batch)
        for key, scale in (("behavior_logps", PT_BEHAVIOR_OFFSET),
                           ("ref_logps", PT_REF_OFFSET)):
            batch[key] = base + scale * torch.randn(
                base.shape, device=dev, generator=g)
        batch["behavior_logps"] -= PT_ADV_SHIFT * batch["advantages"][:, None]
        kw = dict(kl_coef=float(rc.kl_coef or 0.0), clip_eps=rc.clip_eps)
        objective = functools.partial(pst.grpo_objective, **kw)
        keys = ("loss", "pg_loss", "kl", "mean_ratio")
        lp_batches = {"rollout": batch}
        mask = (batch["labels"] != -100).float()

        def metrics_of(lps):
            loss_sum, aux = grpo_token_objective(
                lps["rollout"], batch["behavior_logps"], batch["ref_logps"],
                batch["advantages"], mask, **kw)
            n = mask.sum()
            return dict(loss=loss_sum / n, pg_loss=aux["pg_sum"] / n,
                        kl=aux["kl_sum"] / n, mean_ratio=aux["ratio_sum"] / n)
    else:
        batch = batch_to_device(recipe._pair_batch(
            recipe._pairs[:rc.rollout_batch_size]), dev)
        lp_batches = {h: pst.pair_half(batch, h)
                      for h in ("chosen", "rejected")}
        for half, b in lp_batches.items():
            s = plain_lp(recipe.ref_model, b).sum(dim=-1)
            batch[f"ref_{half}_logp"] = s + PT_SUM_OFFSET * torch.randn(
                s.shape, device=dev, generator=g)
        objective = functools.partial(pst.dpo_objective, beta=recipe.beta)
        keys = ("loss", "accuracy", "margin")

        def metrics_of(lps):
            losses, margins = dpo_losses(
                lps["chosen"].sum(-1), lps["rejected"].sum(-1),
                batch["ref_chosen_logp"], batch["ref_rejected_logp"],
                beta=recipe.beta)
            return dict(loss=losses.mean(), margin=margins.mean())
    first = pt_first_step(label, recipe, batch, objective, keys, lp_batches,
                          metrics_of)
    if not grpo:
        # accuracy: only pairs whose margin is within the band may flip
        with torch.no_grad():
            m = {}
            for name, impl in (("kernel", None), ("plain", "plain")):
                fn = build_logprob_fn(impl=impl, attn_impl=impl)
                sums = {h: fn(model, b).sum(-1)
                        for h, b in lp_batches.items()}
                m[name] = recipe.beta * (
                    (sums["chosen"] - batch["ref_chosen_logp"])
                    - (sums["rejected"] - batch["ref_rejected_logp"]))
        near = int((m["plain"].abs() < PT_MARGIN_BAND).sum())
        flips = int(((m["kernel"] > 0) != (m["plain"] > 0)).sum())
        first["pairs_near_zero"], first["pairs_flipped"] = near, flips
        check(flips <= near,
              f"{label}: {flips} pairs' margins change sign kernel vs plain, "
              f"{near} within {PT_MARGIN_BAND} of 0")
    del batch, lp_batches, metrics_of
    torch.cuda.empty_cache()

    recipe.max_steps = PT_WARM
    recipe.run_post_training_loop()               # warm-up step
    torch.cuda.synchronize()
    handoff = grpo_handoff(label, recipe) if grpo else None

    eng = recipe.engine
    dec0, mixed0 = ((eng.decode_steps, eng.mixed_steps) if grpo
                    else (0, 0))
    cursor0 = recipe.rl_state.data_cursor
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()                    # just before the timed steps
    recipe.max_steps = PT_WARM + PT_TIMED
    t0 = time.perf_counter()
    recipe.run_post_training_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    timed = recipe.history[-PT_TIMED:]
    check(len(recipe.history) == PT_WARM + PT_TIMED,
          f"{label}: {len(recipe.history)} steps ran")
    S = rc.sequence_length
    if grpo:
        n_seq = rc.rollout_batch_size * rc.group_size
        halves, T = 1, n_seq * S
        decode = eng.decode_steps - dec0
        mixed = eng.mixed_steps - mixed0
        # every completion runs to max_new_tokens unless it samples eos;
        # the rollout ends with its longest row
        check(decode == PT_TIMED * (rc.max_new_tokens - 1),
              f"{label}: {decode} decode steps != {PT_TIMED} rollouts x "
              f"{rc.max_new_tokens - 1}")
        check(mixed == PT_TIMED,
              f"{label}: {mixed} prefill steps != one per rollout (64 rows "
              f"x a {rc.max_prompt_len}-token chunk)")
        want_paged, want_gather = L * decode, L * mixed
    else:
        halves, T = 2, rc.rollout_batch_size * S
        want_paged = want_gather = 0
    ref_passes = halves if recipe.ref_model is not None else 0
    per_call = lce.bwd_launches_per_call(T)
    want = dict(
        paged_decode=want_paged, long_q_gather=want_gather,
        # the reference's pass (no remat) and the policy's (forward and
        # its remat re-forward) per half, one backward per layer and half
        attn_fwd=PT_TIMED * L * (ref_passes + 2 * halves),
        attn_bwd=PT_TIMED * L * halves, flash_fwd=0, flash_bwd=0,
        lce_fwd=PT_TIMED * (ref_passes + halves),
        dlogits=PT_TIMED * halves * per_call,
        dh=PT_TIMED * halves * per_call, dw=PT_TIMED * halves * per_call,
        gmm=0, tgmm=0, gmm_quant=0, qdot=0)
    print(f"{label}_launches " + json.dumps(dict(got=counts, want=want)),
          flush=True)
    check(counts == want, f"{label}: launches {counts} != {want}")
    for m in recipe.history:
        check(all(math.isfinite(v) for v in m.values()),
              f"{label}: non-finite metrics {m}")
    step_ms = [m["step_time"] * 1e3 for m in timed]
    split = {k: sum(m.get(f"{k}_ms", 0.0) for m in timed)
             for k in ("rollout", "logprob", "train")}
    report = dict(
        yaml=os.path.relpath(yaml_path, REPO), steps=PT_TIMED,
        wall_s=wall, step_ms=wall * 1e3 / PT_TIMED, step_ms_each=step_ms,
        peak_mem_bytes=peak, launches=counts,
        split_ms=split, **{f"{k}_wall_frac": v / (sum(step_ms) or 1.0)
                           for k, v in split.items()},
        first_step=first, losses=[m["loss"] for m in recipe.history])
    if grpo:
        tokens = sum(m["num_completion_tokens"] for m in timed)
        report.update(
            reward="chip_smoke.lower_vocab_share",
            sequences_per_step=n_seq, rollout_tok_s=float(np.mean(
                [m["rollout_tok_s"] for m in timed])),
            sync_ms=float(np.mean([m["sync_ms"] for m in timed])),
            completion_tokens=tokens, completion_tokens_per_s=tokens / wall,
            rewards=[m["reward_mean"] for m in recipe.history],
            kl=[m["kl"] for m in recipe.history],
            decode_steps=decode, prefill_steps=mixed, handoff=handoff)
    else:
        pairs = [recipe._pairs[i % len(recipe._pairs)] for i in range(
            cursor0, recipe.rl_state.data_cursor)]
        tokens = sum(len(c) + len(r) for _, c, r in pairs)
        report.update(
            pairs=len(pairs), pairs_per_s=len(pairs) / wall,
            completion_tokens=tokens, completion_tokens_per_s=tokens / wall,
            accuracy=[m["accuracy"] for m in recipe.history],
            margin=[m["margin"] for m in recipe.history])
    print(f"{label}_run " + json.dumps(report), flush=True)

    def more():
        recipe.max_steps += PT_PROFILED
        recipe.run_post_training_loop()

    prof = profile_window(more, PT_PROFILED, f"{label}_s{S}", ("Splash<",))
    check(prof["device_ms_per_step"] == "not measured"
          or prof["attention_ms_per_step"] > 0,
          f"{label}: the profile counts no attention kernel by name")
    report["profile"] = prof
    del recipe, model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phi-4-multimodal (sft_phi4_mm_mock, sft_phi4_mm_audio) and VLM decode
# with a cache (generate_gemma3_4b_cord, generate_qwen25_vl_3b_rdr)
# ---------------------------------------------------------------------------
PHI4_MM_MOCK_YAML = os.path.join(VLM_YAMLS, "tiny_phi4_mm_mock.yaml")
PHI4_MM = "microsoft/Phi-4-multimodal-instruct"
PHI4_MM_SEED = 59
# the depth the audio phase runs at: 4 of 32 decoder layers and 6 of 24
# conformer blocks, every width kept (the whole model, ~4.3 B parameters
# without vision, with fp32 masters and Adam leaves no room on one card
# for the phase's time)
PHI4_MM_TEXT_LAYERS = 4
PHI4_MM_AUDIO_BLOCKS = 6
PHI4_MM_STEPS = {"sft_phi4_mm_mock": (0, 6, 0),    # warm-up, timed, profiled
                 "sft_phi4_mm_audio": (1, 2, 1)}
PHI4_AUDIO_ROWS = 48
PHI4_AUDIO_HOP_S = 0.01        # a frame of input_size features: 10 ms
# the published values this script cannot read from a source here, and
# what it takes (named on the phase's line)
PHI4_MM_TAKEN = {
    "sliding_window": "262144 (the published config's, from memory)",
    "bias_max_distance": "500 (the original config's t5_bias_max_distance, "
                         "from memory; transformers' default is 1000)",
    "rope_scaling": "longrope with short_factor / long_factor written as "
                    "48 ones each (the published 48-entry lists are not "
                    "on this machine); the longrope amplitude kept",
}
PHI4_MM_PROCESSOR = {
    "_target_": "automodel_tpu.datasets.vlm.mock.Phi4MMProcessor",
    "vocab_size": 200064, "input_size": 80, "time_reduction": 8,
    "audio_token_id": 200011}


def phi4_mm_config(text_layers, audio_blocks):
    """Phi-4-multimodal-instruct's published text and audio config (HF's
    layout: text fields at the top level, ``audio_config`` nested; no
    vision tower, the JAX scope) at ``text_layers`` / ``audio_blocks``;
    ``PHI4_MM_TAKEN`` names the values not read from a source here."""
    return dict(
        architectures=["Phi4MultimodalForCausalLM"],
        model_type="phi4_multimodal", vocab_size=200064, hidden_size=3072,
        intermediate_size=8192, num_hidden_layers=text_layers,
        num_attention_heads=24, num_key_value_heads=8,
        partial_rotary_factor=0.75, tie_word_embeddings=True,
        rms_norm_eps=1e-5, rope_theta=10000.0,
        original_max_position_embeddings=4096,
        max_position_embeddings=131072, sliding_window=262144,
        rope_scaling={"type": "longrope", "short_factor": [1.0] * 48,
                      "long_factor": [1.0] * 48},
        bos_token_id=199999, eos_token_id=199999, pad_token_id=199999,
        audio_config=dict(
            hidden_size=1024, intermediate_size=1536,
            num_blocks=audio_blocks, num_attention_heads=16, chunk_size=-1,
            left_chunk=18, ext_pw_out_channel=1024,
            depthwise_separable_out_channel=1024, depthwise_multiplier=1,
            kernel_size=3, input_size=80, time_reduction=8,
            bias_max_distance=500, bias_symmetric=False,
            nemo_conv_channels=1024, downsample_rate=1,
            audio_token_id=200011))


def phi4_mm_sample(cfg):
    """The Phi-4-multimodal tensors :func:`write_vlm_model` keeps to check
    the load against."""
    L = cfg["num_hidden_layers"]
    A = cfg["audio_config"]["num_blocks"]
    enc = "model.embed_tokens_extend.audio_embed.encoder."
    return {"model.embed_tokens.weight", "model.norm.weight",
            "model.layers.0.self_attn.qkv_proj.weight",
            f"model.layers.{L - 1}.mlp.gate_up_proj.weight",
            enc + "encoder_embedding.global_invstd", enc + "embed.conv.0.weight",
            enc + "embed.conv.5.weight", enc + "embed.out.weight",
            enc + "relative_attention_bias_layer.bias_values.weight",
            enc + f"encoders.{A - 1}.conv.glu.b1",
            enc + f"encoders.{A - 1}.conv.dw_sep_conv_1d.dw_conv.weight",
            enc + "encoders.0.feed_forward_in.gate_up_proj.weight",
            "model.embed_tokens_extend.audio_embed.up_proj_for_speech.bias"}


def phi4_audio_rows(num_samples=PHI4_AUDIO_ROWS, seed=0, **_kw):
    """``num_samples`` rows in the mock audio set's schema
    (``make_mock_audio_dataset``'s: a user turn, an assistant answer, an
    ``audio`` clip): clips of 24,000-120,000 samples, i.e. 300-1,500
    frames of 80 features (3-15 s at the published 10 ms hop, 38-188 audio
    tokens, under the encoder's 500 frames after subsampling), answers of
    4-24 words; the audio phase's ``dataset._target_``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(int(num_samples)):
        audio = rng.normal(size=(int(rng.integers(24000, 120001)),)).astype(
            np.float32)
        rows.append({
            "conversation": [
                {"role": "user", "content": "What do you hear?"},
                {"role": "assistant", "content": " ".join(
                    rng.choice(WORDS, int(rng.integers(4, 25))))}],
            "audio": {"array": audio, "sampling_rate": 16000}})
    return rows


def conformer_times(model, mb):
    """The conformer's parts on one microbatch ``mb`` (device tensors),
    forward and backward, device times (the kernels' own times in a
    ``torch.profiler`` trace: these eager calls are host-bound, so CUDA
    events would time the host's launch gaps): the whole encoder
    (its blocks recomputed, as in training), the subsampling stack, one
    block's attention core (fp32 logits with the bias and the +1 mask,
    softmax, values) and one block's convolution module; the per-block
    parts times the blocks."""
    import torch

    enc = model.audio_embed.encoder
    ac = enc.config
    feats = mb["input_audio_embeds"]
    mask = mb.get("audio_attention_mask")
    cd = enc.compute_dtype
    N = feats.shape[0]
    T = enc.out_frames(feats.shape[1])
    H, Dh, D = ac.num_attention_heads, ac.head_dim, ac.hidden_size
    g = torch.Generator(device="cuda").manual_seed(5)

    def leaf(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(
            cd).requires_grad_()

    def fwd_bwd(fn, *args):
        def run():
            out = fn(*args)
            out.float().sum().backward()
        return run

    def whole():
        return enc(feats, mask)

    def sub():
        return enc.subsample(feats.float())

    q, k, v, x = leaf(N, T, H, Dh), leaf(N, T, H, Dh), leaf(N, T, H, Dh), \
        leaf(N, T, D)
    add = (torch.zeros(N, H, T, T, device="cuda")
           + enc.rel_bias(T).float()).detach()

    def core():
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        w = torch.softmax(logits * Dh ** -0.5 + add, dim=-1).to(cd)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    def conv():
        return enc._conv_module(enc.blocks[0].conv, x)

    times = {}
    for name, fn in (("encoder", whole), ("subsample", sub),
                     ("attention_core_per_block", core),
                     ("conv_module_per_block", conv)):
        with torch.enable_grad():
            times[name + "_ms"] = traced_device_ms(fwd_bwd(fn), 3)
        model.zero_grad(set_to_none=True)
    blocks = ac.num_blocks
    for part in ("attention_core", "conv_module"):
        one = times[f"{part}_per_block_ms"]
        times[f"{part}_ms"] = None if one is None else one * blocks
    times.update(clips=N, frames=int(feats.shape[1]), encoder_frames=T,
                 blocks=blocks)
    return times


def phi4_mm_phase(label, flush, overrides=(), sections=None, written=None,
                  snap=None, depth_note=None):
    """``tiny_phi4_mm_mock.yaml`` through the port's VLM recipe on the card
    (``recipes/vlm/finetune.py``, what ``automodel-torch finetune vlm``
    runs) with ``overrides`` and the ``sections`` replaced whole (the
    model and the processor of the published phase).  Gates: the loaded
    weights bit for bit as written; kernel 9 at the decoder's heads on the
    first batch's rows, causal and (the raw kernel, which ``attention()``
    runs as causal where the window spans the rows) at the config's
    window, each against its plain version; the first step (the first batch) through the
    kernels against the plain versions within the SFT limits; the exact
    launch counts over the timed steps (kernel 9 forward twice per layer
    and microbatch under remat, backward once, the plain attention never;
    the conformer runs none); the checkpoint the run asks for at one more
    step, read back bit for bit.  Reports step time, non-pad tokens/s,
    audio seconds/s, MFU by the work done (non-pad tokens x
    ``flops_per_token`` less the frozen tied head's dW, plus the encoder
    and the speech projector on the padded frames) beside the JAX count
    (decoder only, ``mfu_jax_count``), peak memory, the conformer's parts
    on the first microbatch and a profiled window's idle share."""
    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.recipes.vlm.finetune import FinetuneRecipeForVLM
    from automodel_tpu_torch.training.train_step import to_device_batch

    warmup, steps, profiled = PHI4_MM_STEPS[label]
    cfg = parse_args_and_load_config(
        ["-c", PHI4_MM_MOCK_YAML, "--step_scheduler.max_steps",
         str(warmup or steps), *overrides])
    for key, value in (sections or {}).items():
        cfg.set_by_dotted(key, dict(value))
    t0 = time.perf_counter()
    recipe = FinetuneRecipeForVLM(cfg).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = recipe.model
    tc, ac = model.config.text_config, model.config.audio_config
    lm = model.language_model
    check(isinstance(recipe.loss_fn, MaskedCrossEntropy),
          f"{label}: loss {type(recipe.loss_fn).__name__}")
    held = 0
    if written is not None:
        held = loaded_equal(label, model, written)
        check(model.checkpoint_dir == snap,
              f"{label}: the model came from {model.checkpoint_dir}")
    ckpt = recipe.checkpoint_config
    ckpt_on = ckpt.enabled
    ckpt.enabled = False                 # until the last step
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    embed_trained = lm.embed_tokens.weight.requires_grad
    window = lm.sliding_window
    L, Hq, Hk, D = (tc.num_hidden_layers, tc.num_attention_heads,
                    tc.num_key_value_heads, tc.head_dim)
    print(f"{label}: {type(model).__name__} text (vocab {tc.vocab_size}, "
          f"hidden {tc.hidden_size}, ffn {tc.intermediate_size}, layers {L}, "
          f"heads {Hq}/{Hk}, head_dim {D}, rotary "
          f"{lm._rotary_dim()} of {D}, window {window}, rope "
          f"{(tc.rope_scaling or {}).get('type', 'default')}, tied "
          f"{tc.tie_word_embeddings}), audio (conformer: {ac.num_blocks} "
          f"blocks, hidden {ac.hidden_size}, ffn {ac.intermediate_size}, "
          f"heads {ac.num_attention_heads}, nemo {ac.nemo_conv_channels} "
          f"channels, time_reduction {ac.time_reduction}, input "
          f"{ac.input_size}, bias distance {ac.bias_max_distance}); "
          f"{depth_note or 'depth as written'}; {model.num_params} params "
          f"{model.param_dtype}, {trainable} trainable (embeddings "
          f"{'trained' if embed_trained else 'frozen'}), {held} written "
          f"tensors held bit for bit; set up in {setup_s:.1f} s", flush=True)

    first = next(iter(recipe.dataloader))
    B, S = first["input_ids"].shape
    cases = [(f"{label}_first_batch_d{D}", B, S, Hq, Hk, D, False, None,
              None)]
    if window is not None:
        cases.append((f"{label}_first_batch_w{window}_d{D}", B, S, Hq, Hk,
                      D, False, window, None))
    attn_rows = attention_phase(flush, None, cases)
    torch.cuda.empty_cache()
    first_step = first_step_check(
        recipe, label,
        [("kernel", recipe.loss_fn, "kernel"),
         ("plain", recipe.loss_fn, "plain"),
         ("kernel_again", recipe.loss_fn, "kernel")],
        [("kernel", "plain")], rows=None)

    seen = []
    run_step = recipe._run_train_optim_step

    def recording(batches):
        seen.append(batches)
        return run_step(batches)

    recipe._run_train_optim_step = recording
    if warmup:
        recipe.run_train_validation_loop()
        recipe.step_scheduler.max_steps += steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0     # zeroed just before the run
    sa.plain_fwd_calls = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = dict(attn_fwd=sa.fwd_launches, attn_bwd=sa.bwd_launches,
                  plain_fwd_calls=sa.plain_fwd_calls)
    peak = torch.cuda.max_memory_allocated()
    del recipe._run_train_optim_step
    check(len(recipe.history) == warmup + steps == len(seen),
          f"{label}: {len(recipe.history)} steps, {len(seen)} groups")
    timed = seen[warmup:]
    micro = sum(len(g) for g in timed)
    want = dict(attn_fwd=2 * L * micro, attn_bwd=L * micro,
                plain_fwd_calls=0)
    check(counts == want, f"{label}: launches {counts} != {want} ({micro} "
          "microbatches)")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"{label} step {m['step']}: non-finite loss/grad_norm")
    pad = getattr(recipe.tokenizer, "pad_token_id", 0) or 0
    tokens = sum(int((np.asarray(mb["input_ids"]) != pad).sum())
                 for g in timed for mb in g)
    frames = sum(int(np.asarray(mb["audio_attention_mask"]).sum())
                 for g in timed for mb in g)
    audio_flops = sum(model.audio_flops(*np.asarray(
        mb["input_audio_embeds"]).shape[:2]) for g in timed for mb in g)
    step_s = sum(m["step_time"] for m in recipe.history[warmup:])
    tok_s = tokens / step_s
    fpt = model.flops_per_token()
    fpt_done = fpt - (0.0 if embed_trained
                      else 2.0 * tc.vocab_size * tc.hidden_size)
    mb0 = {k: v[0] for k, v in to_device_batch([first],
                                               recipe.device).items()}
    parts = conformer_times(model, mb0)
    step_ms = step_s * 1e3 / steps
    per_step_micro = len(timed[0])
    prof = None
    if profiled:
        def more():
            recipe.step_scheduler.max_steps += profiled
            recipe.run_train_validation_loop()

        prof = profile_window(more, profiled, f"{label}_b{B}_s{S}",
                              ("Splash<",))
    # each part's device time for a step's microbatches (the first
    # microbatch's times) over the profiled step's device time and over
    # the step's wall time
    device_step = (prof or {}).get("device_ms_per_step")
    for part in ("encoder", "attention_core", "conv_module", "subsample"):
        ms = parts[f"{part}_ms"]
        ms = None if ms is None else ms * per_step_micro
        parts[f"{part}_share_of_step"] = (
            "not measured" if ms is None else ms / step_ms)
        parts[f"{part}_share_of_device_time"] = (
            ms / device_step if ms is not None
            and isinstance(device_step, float) else "not measured")
    report = dict(
        overrides=list(overrides), sections=sections, depth=depth_note,
        snapshot=snap, written_tensors_held=held, setup_s=setup_s,
        warmup_steps=warmup, steps=steps,
        microbatches_per_step=per_step_micro,
        shapes=sorted({f"{mb['input_ids'].shape[0]}x"
                       f"{mb['input_ids'].shape[1]}" for g in timed
                       for mb in g}),
        audio_shapes=sorted({"x".join(map(str, mb[
            "input_audio_embeds"].shape)) for g in timed for mb in g}),
        non_pad_tokens=tokens, audio_frames=frames,
        audio_s=frames * PHI4_AUDIO_HOP_S, step_ms=step_ms,
        step_ms_each=[m["step_time"] * 1e3
                      for m in recipe.history[warmup:]],
        non_pad_tokens_per_s=tok_s,
        audio_s_per_s=frames * PHI4_AUDIO_HOP_S / step_s,
        flops_per_token=fpt, flops_per_token_done=fpt_done,
        audio_flops=audio_flops,
        mfu=(tok_s * fpt_done + audio_flops / step_s) / BF16_OPS_PER_S,
        mfu_jax_count=tok_s * fpt / BF16_OPS_PER_S,
        loop_s=loop_s, peak_mem_bytes=peak, launches=counts,
        predicted_launches=want, trainable_params=trainable,
        embeddings_trained=embed_trained,
        conformer=parts,
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history],
        first_step=dict(loss_rel_err=first_step["kernel_vs_plain"][
            "loss_rel_err"], grad_rel_l2=first_step["kernel_vs_plain"][
            "grad_rel_l2"], grad_rel_l2_floor=first_step[
            "grad_rel_l2_floor"]),
        profile=prof)
    if ckpt_on:
        # the consolidated save at one more step, read back
        ckpt.enabled = True
        recipe.step_scheduler.max_steps += 1
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        step = recipe.step_scheduler.step
        saved = [d for d in os.listdir(ckpt.checkpoint_dir)
                 if d.endswith(f"_step_{step}")]
        check(len(saved) == 1, f"{label}: checkpoints "
              f"{os.listdir(ckpt.checkpoint_dir)} at step {step}")
        model_dir = os.path.join(ckpt.checkpoint_dir, saved[0], "model")
        save_s = time.perf_counter() - t0
        back = AutoModelForImageTextToText.from_pretrained(
            model_dir, load_weights=True, device=recipe.device)
        live = {n: t.detach() for n, t, _ in hf_io.hf_tensors(model)}
        read = {n: t.detach() for n, t, _ in hf_io.hf_tensors(back)}
        check(sorted(live) == sorted(read),
              f"{label}: the checkpoint's tensors differ")
        differ = [n for n in live if not torch.equal(live[n], read[n])]
        check(not differ, f"{label}: {differ[:3]} read back differently")
        report["checkpoint"] = dict(
            step=step, tensors=len(live), bytes=sum(
                os.path.getsize(os.path.join(model_dir, f))
                for f in os.listdir(model_dir)),
            save_and_step_s=save_s, bit_identical=True)
        del back, live, read
    print(f"{label}_run " + json.dumps(report), flush=True)
    report["attention_cases"] = attn_rows
    del recipe, model, lm
    gc.collect()
    torch.cuda.empty_cache()
    return report


def phi4_mm_phases(hf_home, flush):
    """``tiny_phi4_mm_mock.yaml`` as written, then the same YAML at
    Phi-4-multimodal-instruct's published widths (``PHI4_MM_TEXT_LAYERS``
    of 32 decoder layers, ``PHI4_MM_AUDIO_BLOCKS`` of 24 conformer
    blocks): the model section replaced by the repo id resolved to an
    ``HF_HOME`` snapshot of the published config with random bf16 weights
    (norms around 1, biases N(0, 0.1)), the processor section by the mock
    processor at the published widths, seeded rows in the mock audio
    set's schema (:func:`phi4_audio_rows`), global batch 8 / local 4 and
    a consolidated checkpoint.  The overrides and the values taken are on
    the phase's line."""
    import torch

    runs = {"sft_phi4_mm_mock": phi4_mm_phase("sft_phi4_mm_mock", flush)}
    phase_done("sft_phi4_mm_mock")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_phi4_")
    L, A = PHI4_MM_TEXT_LAYERS, PHI4_MM_AUDIO_BLOCKS
    cfg = phi4_mm_config(L, A)
    snap, written = write_vlm_model(hf_home, PHI4_MM, cfg, PHI4_MM_SEED,
                                    sample=phi4_mm_sample, norm_center=1.0)
    overrides = ["--dataset._target_", "chip_smoke.phi4_audio_rows",
                 "--dataset.num_samples", str(PHI4_AUDIO_ROWS),
                 "--step_scheduler.local_batch_size", "4",
                 "--checkpoint.enabled", "true",
                 "--checkpoint.checkpoint_dir", os.path.join(work, "ckpt")]
    sections = {"model": {"_target_": "automodel_tpu.models.auto_model."
                          "AutoModelForImageTextToText.from_pretrained",
                          "pretrained_model_name_or_path": PHI4_MM},
                "processor": PHI4_MM_PROCESSOR}
    depth = (f"{L} of 32 decoder layers, {A} of 24 conformer blocks, every "
             "width as published; taken: " + json.dumps(PHI4_MM_TAKEN))
    print("sft_phi4_mm_audio overrides: " + " ".join(overrides)
          + " sections=" + json.dumps(sections) + "; " + depth, flush=True)
    runs["sft_phi4_mm_audio"] = phi4_mm_phase(
        "sft_phi4_mm_audio", flush, overrides, sections, written=written,
        snap=snap, depth_note=depth)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.dirname(os.path.dirname(snap)), ignore_errors=True)
    phase_done("sft_phi4_mm_audio")
    return runs


def _first_parting(a, b):
    """The token at which each row of ``a`` and ``b`` parts (None: equal)."""
    import numpy as np

    return [int(np.argmax(x != y)) if (x != y).any() else None
            for x, y in zip(a, b)]


def vlm_generate_phase(label, export_dir, batch, flush, depth_note,
                       windows, tower_blocks=0, model_kwargs=None):
    """Greedy decode through the port's ``generate()`` of an SFT phase's
    consolidated export (``AutoModelForImageTextToText.from_pretrained``):
    ``batch`` holds the mock processor's right-padded prompts, one image
    each, with their ``attention_mask`` and pixels, which ``generate()``
    left-aligns (the padding folded into the prefill's segments).  The
    prefill alone first, through kernel 9 and through the plain version:
    its last logits within 5 % of the logit range and the same argmax;
    then ``GEN_NEW`` tokens a prompt with the kernel prefill and with the
    plain one, the first token of each prompt equal (later tokens
    reported, with the token at which each prompt's runs part, and the
    rows that match exactly).  Kernel 9 launches once per decoder layer
    on the prefill (plus ``tower_blocks``, the Qwen2.5-VL tower's non-
    causal launches) and never on a decode step; the plain prefill
    launches none.  Kernel 9 is held against its plain version at the
    prefill's rows (``windows``: each layer kind's window).  Reports the
    prefill's ms and the decode's tokens/s."""
    import numpy as np
    import torch

    from automodel_tpu_torch.generation import GenerationConfig, generate
    from automodel_tpu_torch.generation.generate import left_align
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import dispatched_window

    t0 = time.perf_counter()
    model = AutoModelForImageTextToText.from_pretrained(
        export_dir, load_weights=True, device="cuda", **(model_kwargs or {}))
    load_s = time.perf_counter() - t0
    dev = next(model.parameters()).device
    tc = model.config.text_config
    L = tc.num_hidden_layers
    ids = np.asarray(batch["input_ids"], np.int64)
    lens = np.asarray(batch["attention_mask"]).sum(1)
    B, S = ids.shape
    kw = {k: torch.as_tensor(np.asarray(v), device=dev)
          for k, v in batch.items() if k.startswith("pixel_values")}
    print(f"{label}: {type(model).__name__} from {export_dir} ({L} text "
          f"layers, heads {tc.num_attention_heads}/"
          f"{tc.num_key_value_heads}, head_dim {tc.head_dim}; "
          f"{depth_note}), {model.param_dtype}, loaded in {load_s:.1f} s; "
          f"{B} prompts of {lens.tolist()} tokens", flush=True)
    generate(model, ids, lens, GenerationConfig(max_new_tokens=2), **kw)
    seg = (np.arange(S)[None, :] >= (S - lens)[:, None]).astype(np.int32)
    # the plans the prefill runs: a window at least as long as the rows
    # runs as full causal (the dispatcher's rule)
    cases = [(f"{label}_prefill_{'full' if w is None else f'w{w}'}"
              f"_d{tc.head_dim}", B, S, tc.num_attention_heads,
              tc.num_key_value_heads, tc.head_dim, seg, w, None)
             for w in dict.fromkeys(dispatched_window(w, S)
                                    for w in windows)]
    attn_rows = attention_phase(flush, None, cases)
    ids_t = torch.as_tensor(ids, device=dev)
    lens_t = torch.as_tensor(lens, device=dev)
    last, prefill_ms = {}, {}
    with torch.inference_mode():
        left = left_align(ids_t, lens_t, 0)
        mask = (torch.arange(S + 1, device=dev)[None, :]
                >= (S - lens_t)[:, None])
        pos = (torch.arange(S, device=dev)[None, :]
               - (S - lens_t)[:, None]).clamp(min=0)
        for impl in ("kernel", "plain"):
            def prefill():
                cache = model.init_kv_cache(B, S + 1)
                return model(left, position_ids=pos, attention_mask=mask,
                             kv_cache=cache, cache_index=0, attn_impl=impl,
                             **kw)["logits"][:, -1].float()
            last[impl] = prefill()
            prefill_ms[impl] = time_ms(prefill, 3, warmup=1)
    span = float(last["plain"].abs().max())
    err = float((last["kernel"] - last["plain"]).abs().max())
    logits = dict(max_abs_err=err, logit_range=span,
                  tol=LOGITS_REL_TOL * span,
                  argmax_equal=bool((last["kernel"].argmax(-1)
                                     == last["plain"].argmax(-1)).all()))
    check(err <= LOGITS_REL_TOL * span,
          f"{label} prefill logits: kernel vs plain max_abs_err {err:.4f} "
          f"> {LOGITS_REL_TOL} * {span:.3f}")
    gcfg = GenerationConfig(max_new_tokens=GEN_NEW)
    out, times, launches = {}, {}, {}
    for impl in ("kernel", "plain"):
        torch.cuda.synchronize()
        sa.fwd_launches = sa.plain_fwd_calls = 0
        t0 = time.perf_counter()
        out[impl] = generate(model, ids, lens, gcfg, attn_impl=impl, **kw)
        torch.cuda.synchronize()
        times[impl] = time.perf_counter() - t0
        launches[impl] = dict(attention_fwd=sa.fwd_launches,
                              plain_fwd_calls=sa.plain_fwd_calls)
        want = L + tower_blocks if impl == "kernel" else 0
        check(sa.fwd_launches == want,
              f"{label} ({impl} prefill): {sa.fwd_launches} kernel 9 "
              f"launches != {want}")
    decode_s = times["kernel"] - prefill_ms["kernel"] / 1e3
    first_equal = bool((out["kernel"][:, 0] == out["plain"][:, 0]).all())
    report = dict(
        export=export_dir, depth=depth_note, prompts=B,
        prompt_lens=lens.tolist(), row_len=S, new_tokens=GEN_NEW,
        load_s=load_s, prefill_ms=prefill_ms["kernel"],
        plain_prefill_ms=prefill_ms["plain"],
        decode_tok_s=B * (GEN_NEW - 1) / decode_s,
        generate_s=times["kernel"], plain_generate_s=times["plain"],
        tok_s=B * GEN_NEW / times["kernel"], launches=launches["kernel"],
        plain_launches=launches["plain"], prefill_logits=logits,
        first_tokens_equal=first_equal,
        rows_identical=int(sum(bool((a == b).all()) for a, b in
                               zip(out["kernel"], out["plain"]))),
        first_parting_token=_first_parting(out["kernel"], out["plain"]))
    print(f"{label} " + json.dumps(report), flush=True)
    check(first_equal and logits["argmax_equal"],
          f"{label}: the prompts' first tokens differ between the kernel and "
          f"the plain prefill ({out['kernel'][:, 0]} vs {out['plain'][:, 0]})")
    report["attention_cases"] = attn_rows
    report["launches"] = dict(attn_fwd=launches["kernel"]["attention_fwd"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _prompt_words(rng, n):
    return " ".join(rng.choice(WORDS, n))


def generate_gemma3_4b_phase(export_dir, flush):
    """``generate_gemma3_4b_cord``: 4 prompts of one receipt-sized image
    and 8-64 words each through the mock processor at Gemma-3-4B's widths
    (896 px, 256 placeholders) over ``sft_gemma3_4b_cord``'s export."""
    import numpy as np

    from automodel_tpu_torch.datasets.vlm.collate_fns import to_nhwc
    from automodel_tpu_torch.datasets.vlm.mock import MockVLMProcessor

    rng = np.random.default_rng(83)
    proc = MockVLMProcessor(vocab_size=262208, image_size=896, patch_size=56,
                            image_token_id=262144)
    texts, images = [], []
    for n in (8, 24, 40, 64):
        conv = [{"role": "user", "content": [
            {"type": "image"}, {"type": "text", "text": _prompt_words(rng,
                                                                      n)}]}]
        texts.append(proc.apply_chat_template(conv))
        images.append([rng.integers(0, 256, (320, 240, 3)).astype(
            np.uint8)])
    batch = proc(text=texts, images=images)
    batch["pixel_values"] = to_nhwc(batch["pixel_values"])
    return vlm_generate_phase(
        "generate_gemma3_4b_cord", export_dir, batch, flush,
        f"{GEMMA3_4B_LAYERS} of 34 text layers, the depth "
        "sft_gemma3_4b_cord trains at", windows=(1024, None))


def generate_qwen25_vl_3b_phase(export_dir, flush):
    """``generate_qwen25_vl_3b_rdr``: 4 prompts of one image and 8-64
    words each through the mock processor at the published patch geometry
    (56 x 56 patches, 784 merged units) over ``sft_qwen25_vl_3b_rdr``'s
    export; 1-D text positions, as JAX's ``generate()`` passes them."""
    import numpy as np

    from automodel_tpu_torch.datasets.vlm.mock import Qwen2_5_VLProcessor

    rng = np.random.default_rng(89)
    proc = Qwen2_5_VLProcessor(vocab_size=151936, grid=(1, 56, 56),
                               patch_size=14)
    texts, images = [], []
    for n in (8, 24, 40, 64):
        conv = [{"role": "user", "content": [
            {"type": "image"}, {"type": "text", "text": _prompt_words(rng,
                                                                      n)}]}]
        texts.append(proc.apply_chat_template(conv))
        images.append([rng.integers(0, 256, (600, 800, 3)).astype(
            np.uint8)])
    batch = proc(text=texts, images=images)
    batch.pop("image_grid_thw")
    return vlm_generate_phase(
        "generate_qwen25_vl_3b_rdr", export_dir, batch, flush,
        f"{QWEN25_VL_TEXT_LAYERS} of 36 text layers and vision blocks "
        f"0-{QWEN25_VL_VISION_BLOCKS - 1} of 32, the depth "
        "sft_qwen25_vl_3b_rdr trains at", windows=(None,),
        tower_blocks=QWEN25_VL_VISION_BLOCKS,
        model_kwargs=dict(image_grid=(1, 56, 56)))


T0 = time.perf_counter()


def phase_done(name):
    """Print the script's elapsed seconds at the end of a phase."""
    print(f"phase {name} done at {time.perf_counter() - T0:.1f} s",
          flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, REPO)
    try:
        from automodel_tpu_torch.ops.kernel_lib import build
    except ImportError as e:
        fail(f"the automodel_tpu_torch package is not beside this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)

    t0 = time.perf_counter()
    sources = ["paged_decode", "flash_attn_fwd", "flash_attn_bwd",
               "linear_ce_fwd", "linear_ce_bwd", "gmm", "qdot", "gmm_quant",
               "flash_mha_fwd", "flash_mha_bwd"]
    build.build_many(sources)
    print(f"build: {', '.join(n + '.cu' for n in sources)} (one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.1f} s", flush=True)

    seg = first_batch(SFT_YAML)["segment_ids"]
    lite_first = first_batch(LITE_YAML)
    lite_seg = lite_first["segment_ids"]
    bench_first = first_batch(BENCH_YAML)
    bench_labels = bench_first["labels"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = kernel_phase(flush)
    phase_done("paged_decode kernel")
    lora_cases = lora_gmm_phase(flush)
    phase_done("lora gmm kernel")
    attn_cases = attention_phase(flush, seg)
    mla_cases = attention_phase(flush, lite_seg, MLA_CASES, MLA_V_HEAD_DIM)
    gemma_cases = attention_phase(flush, None, GEMMA_ATTN_CASES)
    pt_attn_cases = attention_phase(flush, None, PT_ATTN_CASES)
    phase_done("attention kernels")
    flash_cases = flash_phase(flush, bench_first["segment_ids"])
    phase_done("flash kernels")
    lce_cases = linear_ce_phase(flush, bench_labels)
    # DeepSeek-V2-Lite's head (sft_deepseek's V 102,400) on its first
    # batch's labels
    lite_labels = lite_first["labels"]
    lce_lite = lce_case("sft_deepseek_v102400", lite_labels.size, 2048,
                        102400, "bench", lite_labels, flush, seed=260,
                        parts=True)
    phase_done("linear-CE kernels")
    q_cases = qdot_phase(flush)
    phase_done("qdot kernel")
    main_run = engine_phase()
    phase_done("engine")
    torch.cuda.empty_cache()
    features = serving_features_phase()
    phase_done("serving_features")
    torch.cuda.empty_cache()
    serve_moe = engine_phase(MOE_SERVE_YAML, "serve_moe", flush,
                             layers=MOE_SERVE_LAYERS)
    phase_done("serve_moe")
    # the HF-directory phases resolve their YAMLs' repo ids here
    hf_home = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    os.environ["HF_HOME"] = hf_home
    torch.cuda.empty_cache()
    serve_qwen2 = serve_qwen2_phase(hf_home, flush)
    phase_done("serve_qwen2")
    sft = train_phase("sft", SFT_YAML)
    phase_done("sft")
    torch.cuda.empty_cache()
    bench = train_phase("sft_bench", BENCH_YAML, sync_report=True)
    phase_done("sft_bench")
    torch.cuda.empty_cache()
    new_runs = {"sft_unpacked": train_phase(
        "sft_unpacked", BENCH_YAML, UNPACKED_OVERRIDES,
        first_step="all_plain")}
    phase_done("sft_unpacked")
    torch.cuda.empty_cache()
    new_runs["sft_long_16k"] = train_phase("sft_long_16k", BENCH_YAML,
                                           LONG_OVERRIDES)
    torch.cuda.empty_cache()
    long_case = long_attention_case(
        first_batch(BENCH_YAML, LONG_OVERRIDES)["segment_ids"])
    phase_done("sft_long_16k")
    torch.cuda.empty_cache()
    residuals = new_runs["sft_remat_residuals"] = train_phase(
        "sft_remat_residuals", BENCH_YAML, RESIDUALS_OVERRIDES,
        first_step="remat")
    check(residuals["bwd_launches"] == bench["bwd_launches"],
          f"sft_remat_residuals: {residuals['bwd_launches']} backward "
          f"launches, sft_bench {bench['bwd_launches']}")
    L = 16
    saved = L * (8 * 2048 * 32 * 64 * 2 + 8 * 32 * 2048 * 4)
    mem = dict(peak_mem_bytes=residuals["peak_mem_bytes"],
               sft_bench_peak_mem_bytes=bench["peak_mem_bytes"],
               above_sft_bench_bytes=residuals["peak_mem_bytes"]
               - bench["peak_mem_bytes"],
               residual_bytes_16_layers=saved,
               step_ms=residuals["step_ms"],
               sft_bench_step_ms=bench["step_ms"])
    print("sft_remat_residuals_memory " + json.dumps(mem), flush=True)
    phase_done("sft_remat_residuals")
    check(bench["peak_mem_bytes"] < sft["peak_mem_bytes"],
          f"sft_bench peak memory {bench['peak_mem_bytes']} is not below the "
          f"MaskedCE sft phase's {sft['peak_mem_bytes']}")
    peft_runs = {}
    for label, over in (("sft_peft", ()),
                        ("sft_qlora_int8", ("--peft.quantize_base", "int8"))):
        torch.cuda.empty_cache()
        peft_runs[label] = train_phase(label, PEFT_YAML, over)
        phase_done(label)
        check(peft_runs[label]["peak_mem_bytes"] < bench["peak_mem_bytes"],
              f"{label} peak memory {peft_runs[label]['peak_mem_bytes']} is "
              f"not below sft_bench's {bench['peak_mem_bytes']}")
    torch.cuda.empty_cache()
    sft_flash = train_phase("sft_flash", BENCH_YAML, attn_impl="flash")
    phase_done("sft_flash")
    torch.cuda.empty_cache()
    ckpt_phase()
    phase_done("ckpt")
    torch.cuda.empty_cache()
    fp8 = train_phase("sft_fp8", BENCH_YAML,
                      ["--fp8.enabled", "true", "--fp8.dtype", "float8"],
                      bf16=bench)
    phase_done("sft_fp8")
    torch.cuda.empty_cache()
    moe = train_phase("sft_moe", MOE_YAML)
    phase_done("sft_moe")
    torch.cuda.empty_cache()
    moe_fp8 = train_phase("sft_moe_fp8", MOE_YAML,
                          ["--fp8.enabled", "true", "--fp8.dtype", "int8"],
                          bf16=moe)
    phase_done("sft_moe_fp8")
    torch.cuda.empty_cache()
    deepseek = train_phase("sft_deepseek", LITE_YAML)
    phase_done("sft_deepseek")
    torch.cuda.empty_cache()
    gen_deepseek = generate_deepseek_phase()
    phase_done("generate_deepseek")
    hf_runs = {}
    for label, yaml_path, repo_id, kind in (
            ("sft_qwen3_hellaswag", QWEN3_HELLASWAG_YAML, "Qwen/Qwen3-0.6B",
             "hellaswag"),
            ("sft_llama_squad", LLAMA_SQUAD_YAML, "meta-llama/Llama-3.2-1B",
             "squad")):
        torch.cuda.empty_cache()
        hf_runs[label] = hf_sft_phase(label, yaml_path, repo_id, kind,
                                      hf_home, flush)
        phase_done(label)
    # the VLM recipe: the bench YAML as written, then Gemma-3-4B-it
    torch.cuda.empty_cache()
    vlm_runs = {"sft_gemma3_vl_bench": vlm_sft_phase(
        "sft_gemma3_vl_bench", GEMMA3_BENCH_YAML, (), flush)}
    phase_done("sft_gemma3_vl_bench")
    torch.cuda.empty_cache()
    vlm_runs["sft_gemma3_4b_cord"] = gemma3_4b_cord_phase(hf_home, flush)
    phase_done("sft_gemma3_4b_cord")
    # greedy decode over that phase's export (kernel 9 on the prefill)
    torch.cuda.empty_cache()
    cord = vlm_runs["sft_gemma3_4b_cord"]
    gen_runs = {"generate_gemma3_4b_cord": generate_gemma3_4b_phase(
        cord["export_dir"], flush)}
    shutil.rmtree(cord["work_dir"], ignore_errors=True)
    phase_done("generate_gemma3_4b_cord")
    # Qwen2.5-VL: kernel 9 at the tower's non-causal shapes, then the RDR
    # YAML at Qwen2.5-VL-3B's widths and the video YAML as written
    torch.cuda.empty_cache()
    qwen_cases = attention_phase(flush, None, qwen_attn_cases())
    phase_done("qwen2.5-vl attention cases")
    qwen_runs = {"sft_qwen25_vl_3b_rdr": qwen25_vl_3b_rdr_phase(hf_home,
                                                                flush)}
    phase_done("sft_qwen25_vl_3b_rdr")
    torch.cuda.empty_cache()
    rdr = qwen_runs["sft_qwen25_vl_3b_rdr"]
    gen_runs["generate_qwen25_vl_3b_rdr"] = generate_qwen25_vl_3b_phase(
        rdr["export_dir"], flush)
    shutil.rmtree(rdr["work_dir"], ignore_errors=True)
    phase_done("generate_qwen25_vl_3b_rdr")
    torch.cuda.empty_cache()
    qwen_runs["sft_qwen25_vl_video_mock"] = qwen_vl_phase(
        "sft_qwen25_vl_video_mock", QWEN_VIDEO_YAML, flush,
        "qwen25vl_video_mock_text_d16")
    phase_done("sft_qwen25_vl_video_mock")
    # Gemma-3n: kernel 9 at E4B's shapes (GQA 8 / 2 at D 256, scale 1.0,
    # window 512 and full), then the two MedPix YAMLs at E4B's widths and
    # the tiny mock YAML as written
    torch.cuda.empty_cache()
    gemma3n_cases = attention_phase(flush, None, GEMMA3N_ATTN_CASES)
    phase_done("gemma3n attention cases")
    g3n_runs = gemma3n_phases(hf_home, flush)
    # Phi-4-multimodal: the tiny YAML as written, then the published
    # widths (the conformer audio encoder, the fused Phi decoder on
    # kernel 9)
    torch.cuda.empty_cache()
    phi4_runs = phi4_mm_phases(hf_home, flush)
    # post-training: GRPO (rollouts through the engine) and DPO
    pt_runs = {}
    for label, yaml_path in (("grpo_llama_1b", GRPO_YAML),
                             ("dpo_llama_1b", DPO_YAML)):
        torch.cuda.empty_cache()
        pt_runs[label] = post_train_phase(label, yaml_path)
        phase_done(label)
    # pretraining (the nanoGPT YAML), sequence classification and the
    # Granite / OLMo-2 / StarCoder-2 / Phi-3 families
    torch.cuda.empty_cache()
    text_runs = {"pretrain_gpt2_nanogpt": pretrain_gpt2_phase(flush)}
    phase_done("pretrain_gpt2_nanogpt")
    torch.cuda.empty_cache()
    seqcls = seqcls_phase(hf_home, flush)
    phase_done("sft_seqcls_llama_1b")
    for label, repo_id, over, first_step in FAMILY_PHASES:
        torch.cuda.empty_cache()
        text_runs[label] = family_sft_phase(label, repo_id, over,
                                              first_step, hf_home, flush)
        phase_done(label)
    family_attn = attention_phase(flush, seg, FAMILY_ATTN_CASES)
    phase_done("family attention cases")
    del flush
    shutil.rmtree(hf_home, ignore_errors=True)
    # last: its two recipes are set up and dropped here, after every timed
    # phase
    torch.cuda.empty_cache()
    quant_check_phase()
    phase_done("quant_check")

    # paged decode: ms and library_ms are the kernels' own device time (the
    # wrapper's host work, longer than the kernels, hidden); call_ms and
    # library_call_ms the calls' as the host issues them
    rep = cases[0]
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "automodel_tpu_torch/csrc/paged_decode.cu",
        "replaces": "automodel_tpu/ops/paged_attention_kernel.py:113",
        "launches": main_run["kernel_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": rep["device_ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_device_ms"],
        "redesigned": "split-KV; mma.sync for bf16 q",
        "call_ms": rep["ms"], "library_call_ms": rep["library_ms"],
        "span": rep["span"], "splits": rep["splits"],
    }]
    # the speculative verify width (S = 5), bf16 and int8 pools, and the
    # kernel's launches on the serving_features runs
    for c in cases:
        if c["case"] in ("verify_s5_d64_bf16", "verify_s5_d64_int8"):
            kv = c["kv"]
            kernels[-1].update({
                f"verify_s5_{kv}_ms": c["device_ms"],
                f"verify_s5_{kv}_plain_ms": c["plain_ms"],
                f"verify_s5_{kv}_bound_ms": c["bound_ms"],
                f"verify_s5_{kv}_library_ms": c["library_device_ms"]})
    # Qwen3-30B-A3B's decode and verify shapes (serve_moe)
    for c in cases:
        if c["case"].startswith("qwen3_"):
            tag = c["case"].replace("qwen3_", "qwen3_serve_")
            kernels[-1].update({
                f"{tag}_ms": c["device_ms"],
                f"{tag}_plain_ms": c["plain_ms"],
                f"{tag}_bound_ms": c["bound_ms"],
                f"{tag}_library_ms": c["library_device_ms"]})
    # Qwen2.5-1.5B's decode and verify shapes (serve_qwen2, G 6)
    for c in cases:
        if c["case"].startswith("qwen2_"):
            tag = c["case"].replace("qwen2_", "qwen2_serve_")
            kernels[-1].update({
                f"{tag}_ms": c["device_ms"],
                f"{tag}_plain_ms": c["plain_ms"],
                f"{tag}_bound_ms": c["bound_ms"],
                f"{tag}_library_ms": c["library_device_ms"]})
    # GRPO's rollout decode (batch 64, contexts up to 256) and launches
    for c in cases:
        if c["case"].startswith("grpo_"):
            kernels[-1].update({
                f"{c['case']}_ms": c["device_ms"],
                f"{c['case']}_plain_ms": c["plain_ms"],
                f"{c['case']}_bound_ms": c["bound_ms"],
                f"{c['case']}_library_ms": c["library_device_ms"]})
    kernels[-1]["grpo_llama_1b_launches"] = pt_runs["grpo_llama_1b"][
        "launches"]["paged_decode"]
    kernels[-1]["serve_moe_launches"] = serve_moe["kernel_launches"]
    kernels[-1]["serve_qwen2_launches"] = serve_qwen2["kernel_launches"]
    # quantized serving and the fleet
    kernels[-1]["serve_fp8_launches"] = main_run["fp8"]["run"][
        "kernel_launches"]
    kernels[-1]["serve_moe_fp8_launches"] = serve_moe["fp8"]["run"][
        "kernel_launches"]
    kernels[-1]["serve_int8_base_launches"] = main_run["int8_base"][
        "paged_decode_launches"]
    kernels[-1]["serve_fleet_launches"] = main_run["fleet"][
        "paged_decode_launches"]
    kernels[-1]["serving_features_launches"] = {
        "prefix_on_bf16": features["prefix_cache"]["bf16"]["on"][
            "paged_decode_launches"],
        "prefix_on_int8": features["prefix_cache"]["int8"]["on"][
            "paged_decode_launches"],
        "speculative_periodic_on": features["speculative"]["periodic"][
            "on"]["paged_decode_launches"],
        "multi_lora_n4_mixed": features["multi_lora"]["n4"]["mixed"][
            "paged_decode_launches"],
    }
    for part, launches in (("fwd", sft["fwd_launches"]),
                           ("bwd", sft["bwd_launches"])):
        rep = attn_cases[0][part]
        causal = causal_case(attn_cases)[part]
        kernels.append({
            "name": f"flash_attn_{part}", "route": "cuda",
            "source": f"automodel_tpu_torch/csrc/flash_attn_{part}.cu",
            "replaces": "automodel_tpu/ops/splash_attention.py:129",
            "launches": launches,
            "max_abs_err": max(c[part]["max_abs_err"] for c in attn_cases),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "causal_ms": causal["ms"],
            "causal_library_ms": causal["library_ms"],
        })
        for name_, run in {**peft_runs, **new_runs}.items():
            kernels[-1][f"{name_}_launches"] = run[f"{part}_launches"]
        kernels[-1]["long_16k_ms"] = long_case[part]["ms"]
        # head_dim 192 (MLA, sft_deepseek's packing and pure causal)
        mla = mla_cases[0][part]
        kernels[-1].update({
            "mla_d192_ms": mla["ms"], "mla_d192_plain_ms": mla["plain_ms"],
            "mla_d192_bound_ms": mla["bound_ms"],
            "mla_d192_bound_by": mla["bound_by"],
            "mla_d192_padded_bound_ms": mla["padded_bound_ms"],
            "mla_d192_library_ms": mla["library_ms"],
            "mla_causal_d192_ms": mla_cases[1][part]["ms"],
            "mla_causal_d192_bound_ms": mla_cases[1][part]["bound_ms"],
            "mla_causal_d192_padded_bound_ms": mla_cases[1][part][
                "padded_bound_ms"],
            "mla_causal_d192_library_ms": mla_cases[1][part]["library_ms"],
            "sft_deepseek_launches": deepseek[f"{part}_launches"]})
        kernels[-1]["max_abs_err"] = max(
            kernels[-1]["max_abs_err"],
            max(c[part]["max_abs_err"] for c in mla_cases))
        if part == "fwd":
            kernels[-1]["generate_deepseek_launches"] = gen_deepseek[
                "launches"]["attention_fwd"]
            kernels[-1]["generate_deepseek_fp8_launches"] = gen_deepseek[
                "fp8"]["launches"]["attention_fwd"]
        # the Gemma shapes (head_dim 128 and 256, windows, cap 50), the
        # post-training rows and the VLM phases' first batches and launches
        for c in gemma_cases + pt_attn_cases + [r["attention_cases"][0]
                                for r in vlm_runs.values()]:
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_bound_by": c[part]["bound_by"],
                f"{c['case']}_library_ms": c[part]["library_ms"],
                f"{c['case']}_attended_pairs": c["attended_pairs"]})
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             c[part]["max_abs_err"])
        for label, run in {**vlm_runs, **pt_runs}.items():
            kernels[-1][f"{label}_launches"] = run["launches"][
                f"attn_{part}"]
        # this slice's shapes: GPT-2 124M, the classifier's padded rows,
        # the four families' first batches (Granite's scale, StarCoder-2's
        # window 4,096 at S 8,192, Phi-4), Phi-3.5-mini's D 96 (padded) and
        # Granite's scale on the bench packing, and each phase's launches
        for c in family_attn + seqcls["attention_cases"] + [
                r["attention_cases"][0] for r in text_runs.values()]:
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_bound_by": c[part]["bound_by"],
                f"{c['case']}_library_ms": c[part]["library_ms"]})
            if "padded_bound_ms" in c[part]:
                kernels[-1][f"{c['case']}_padded_bound_ms"] = c[part][
                    "padded_bound_ms"]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             c[part]["max_abs_err"])
        for label, run in text_runs.items():
            kernels[-1][f"{label}_launches"] = run[f"{part}_launches"]
        kernels[-1]["sft_seqcls_llama_1b_launches"] = seqcls["launches"][
            f"attn_{part}"]
        # Qwen2.5-VL: the tower's non-causal shapes at head_dim 80 (the
        # model's bound and the padded width's), the phases' decoder rows,
        # and each phase's launches
        for c in qwen_cases + [r["attention_cases"][0]
                               for r in qwen_runs.values()]:
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_bound_by": c[part]["bound_by"],
                f"{c['case']}_library_ms": c[part]["library_ms"]})
            if "padded_bound_ms" in c[part]:
                kernels[-1][f"{c['case']}_padded_bound_ms"] = c[part][
                    "padded_bound_ms"]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             c[part]["max_abs_err"])
        for label, run in qwen_runs.items():
            kernels[-1][f"{label}_launches"] = run["launches"][
                f"attn_{part}"]
        # Gemma-3n: E4B's shapes at scale 1.0, the phases' decoder rows,
        # and each phase's launches
        for c in gemma3n_cases + [r["attention_cases"][0]
                                  for r in g3n_runs.values()]:
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_bound_by": c[part]["bound_by"],
                f"{c['case']}_library_ms": c[part]["library_ms"]})
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             c[part]["max_abs_err"])
        for label, run in g3n_runs.items():
            kernels[-1][f"{label}_launches"] = run["launches"][
                f"attn_{part}"]
        # Phi-4-multimodal's decoder rows (causal, and the raw kernel at
        # the published window, which attention() runs as causal: marked
        # off the path) and each phase's launches; the generate phases'
        # prefill rows (the prompts' left padding folded into segments)
        # and their launches (forward only: decode steps take the plain
        # cache path)
        for c in [c for r in list(phi4_runs.values())
                  + list(gen_runs.values()) for c in r["attention_cases"]]:
            if not c["on_path"]:
                kernels[-1][f"{c['case']}_on_path"] = False
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_bound_by": c[part]["bound_by"],
                f"{c['case']}_library_ms": c[part]["library_ms"]})
            if "padded_bound_ms" in c[part]:
                kernels[-1][f"{c['case']}_padded_bound_ms"] = c[part][
                    "padded_bound_ms"]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             c[part]["max_abs_err"])
        for label, run in phi4_runs.items():
            kernels[-1][f"{label}_launches"] = run["launches"][
                f"attn_{part}"]
        if part == "fwd":
            for label, run in gen_runs.items():
                kernels[-1][f"{label}_launches"] = run["launches"][
                    "attn_fwd"]
        # the HF YAMLs' rows (unpacked, padding folded into segments)
        for label, run in hf_runs.items():
            c = run["attention_cases"][0]
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_library_ms": c[part]["library_ms"],
                f"{label}_launches": run["launches"][f"attn_{part}"]})
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             c[part]["max_abs_err"])
    rep = lce_cases[0]
    new_lce = ([lce_lite] + [r["lce_case"] for r in vlm_runs.values()]
               + [r["lce_case"] for r in text_runs.values()])
    lce_cases = lce_cases + [r["lce_case"] for r in hf_runs.values()
                             if r["lce_case"] is not None] + new_lce
    errs = dict(
        fwd=max(max(c["fwd"]["lse_max_abs_err"], c["fwd"]["pick_max_abs_err"])
                for c in lce_cases),
        dlogits=max(c["dlogits_max_abs_err"] for c in lce_cases),
        dh=max(c["bwd"]["dh_max_abs_err"] for c in lce_cases),
        dw=max(c["bwd"]["dw_max_abs_err"] for c in lce_cases))
    lce_src = "automodel_tpu_torch/csrc/linear_ce_{}.cu"
    for part, src, line in (("fwd", "fwd", 132), ("dlogits", "bwd", 209),
                            ("dh", "bwd", 222), ("dw", "bwd", 248)):
        got = rep[part]
        kernels.append({
            "name": f"linear_ce_{part}", "route": "cuda",
            "source": lce_src.format(src),
            "replaces": f"automodel_tpu/ops/linear_ce_kernel.py:{line}",
            "launches": bench["linear_ce_launches"][part],
            "max_abs_err": errs[part],
            "ms": got["ms"], "plain_ms": got["plain_ms"],
            "bound_ms": got["bound_ms"], "bound_by": got["bound_by"],
            "library_ms": got["library_ms"],
        })
        kernels[-1]["redesigned"] = "wgmma + TMA, persistent"
        for name_, run in {**peft_runs, **new_runs}.items():   # PEFT: no dW
            kernels[-1][f"{name_}_launches"] = run["linear_ce_launches"][part]
        kernels[-1]["sft_deepseek_launches"] = deepseek[
            "linear_ce_launches"][part]
        for label, run in hf_runs.items():
            kernels[-1][f"{label}_launches"] = run["launches"][
                "lce_fwd" if part == "fwd" else part]
            c = run["lce_case"]
            if c is not None:       # a vocabulary no earlier phase trains
                kernels[-1].update({
                    f"{c['case']}_ms": c[part]["ms"],
                    f"{c['case']}_plain_ms": c[part]["plain_ms"],
                    f"{c['case']}_bound_ms": c[part]["bound_ms"],
                    f"{c['case']}_library_ms": c[part]["library_ms"]})
        # V 102,400 (sft_deepseek), 32,768 (the VLM bench) and 262,208
        # (Gemma-3-4B), and the VLM phases' launches
        for c in new_lce:
            kernels[-1].update({
                f"{c['case']}_ms": c[part]["ms"],
                f"{c['case']}_plain_ms": c[part]["plain_ms"],
                f"{c['case']}_bound_ms": c[part]["bound_ms"],
                f"{c['case']}_library_ms": c[part]["library_ms"]})
        for label, run in {**vlm_runs, **pt_runs}.items():
            kernels[-1][f"{label}_launches"] = run["launches"][
                "lce_fwd" if part == "fwd" else part]
        # GPT-2's and the families' heads (Granite's divisor folded in);
        # the classifier launches none
        for label, run in text_runs.items():
            kernels[-1][f"{label}_launches"] = run["linear_ce_launches"][part]
        kernels[-1]["sft_seqcls_llama_1b_launches"] = seqcls["launches"][
            "lce_fwd" if part == "fwd" else part]
        # the post-training shapes with their objectives' cotangents
        for c in lce_cases:
            if c["labels"] in PT_LCE_KINDS:
                kernels[-1].update({
                    f"{c['case']}_ms": c[part]["ms"],
                    f"{c['case']}_plain_ms": c[part]["plain_ms"],
                    f"{c['case']}_bound_ms": c[part]["bound_ms"],
                    f"{c['case']}_library_ms": c[part]["library_ms"]})
        if part == "fwd":
            kernels[-1]["product_ms"] = got["product_ms"]
        if part == "dlogits":
            kernels[-1]["product_library_ms"] = got["product_library_ms"]
    gmm_cases = moe["gmm_cases"]
    lite_gmm = deepseek["gmm_cases"]
    for kname, parts, line in (("gmm", ("gmm", "dlhs"), 187),
                               ("tgmm", ("tgmm",), 256)):
        got = gmm_cases[0][kname]        # routed rows, gate/up projection
        extra = {}
        # DeepSeek-V2-Lite's routed shapes (sft_deepseek)
        for c in lite_gmm:
            extra.update({f"{c['case']}_ms": c[kname]["ms"],
                          f"{c['case']}_plain_ms": c[kname]["plain_ms"],
                          f"{c['case']}_bound_ms": c[kname]["bound_ms"],
                          f"{c['case']}_library_ms": c[kname]["library_ms"]})
        extra["sft_deepseek_launches"] = deepseek["gmm_launches"][kname]
        if kname == "gmm":
            # the engine's routed shapes (serve_moe)
            for c in serve_moe["gmm_cases"]:
                extra.update({
                    f"{c['case']}_ms": c["gmm"]["ms"],
                    f"{c['case']}_plain_ms": c["gmm"]["plain_ms"],
                    f"{c['case']}_bound_ms": c["gmm"]["bound_ms"],
                    f"{c['case']}_library_ms": c["gmm"]["library_ms"]})
            extra["serve_moe_launches"] = serve_moe["gmm_launches"]
            extra["generate_deepseek_launches"] = gen_deepseek[
                "launches"]["gmm"]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "automodel_tpu_torch/csrc/gmm.cu",
            "replaces": f"automodel_tpu/ops/gmm_kernel.py:{line}",
            "launches": moe["gmm_launches"][kname],
            "max_abs_err": max(c[p]["max_abs_err"] for c in
                               gmm_cases + lite_gmm + serve_moe["gmm_cases"]
                               for p in parts),
            "ms": got["ms"], "plain_ms": got["plain_ms"],
            "bound_ms": got["bound_ms"], "bound_by": got["bound_by"],
            "library_ms": got["library_ms"],
            "redesigned": "wgmma + TMA, persistent",
            **extra,
        })
        if kname == "gmm":     # its transposed-rhs form, the dlhs
            dl = gmm_cases[0]["dlhs"]
            kernels[-1].update(dlhs_ms=dl["ms"], dlhs_plain_ms=dl["plain_ms"],
                               dlhs_bound_ms=dl["bound_ms"],
                               dlhs_library_ms=dl["library_ms"])
            # the multi-LoRA delta's rank-8 products, and the kernel's
            # launches on the mixed multi-tenant runs
            for c in lora_cases:
                kernels[-1].update({
                    f"{c['case']}_ms": c["device_ms"],
                    f"{c['case']}_call_ms": c["ms"],
                    f"{c['case']}_plain_ms": c["plain_ms"],
                    f"{c['case']}_bound_ms": c["bound_ms"],
                    f"{c['case']}_library_ms": c["library_ms"]})
            kernels[-1]["max_abs_err"] = max(
                kernels[-1]["max_abs_err"],
                max(c["max_abs_err"] for c in lora_cases))
            kernels[-1]["multi_lora_launches"] = {
                f"n{n}_mixed": features["multi_lora"][f"n{n}"][
                    "gmm_launches"] for n in (1, 4, 16)}
    rep = q_cases[0]          # the sft_fp8 forward of q_proj
    kernels.append({
        "name": "qdot", "route": "cuda",
        "source": "automodel_tpu_torch/csrc/qdot.cu",
        "replaces": "automodel_tpu/ops/qdot_kernel.py:89",
        "launches": fp8["qdot_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in q_cases),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "redesigned": "wgmma + TMA, persistent",
        "serve_fp8_launches": main_run["fp8"]["run"]["qdot_launches"],
        "serve_moe_fp8_launches": serve_moe["fp8"]["run"]["qdot_launches"],
    })
    # the engine's decode rows and prefill chunk (serve_fp8)
    for c in q_cases:
        if c["case"].startswith("serve_fp8_"):
            kernels[-1].update({
                f"{c['case']}_ms": c["ms"],
                f"{c['case']}_plain_ms": c["plain_ms"],
                f"{c['case']}_bound_ms": c["bound_ms"],
                f"{c['case']}_bound_by": c["bound_by"],
                f"{c['case']}_library_ms": c["library_ms"]})
    gq_cases = moe_fp8["gmm_cases"]
    rep = gq_cases[0]         # routed gate/up rows, int8
    e4m3 = next(c for c in gq_cases if c["case"] == "routed_gate_up_e4m3")
    kernels.append({
        "name": "gmm_quant", "route": "cuda",
        "source": "automodel_tpu_torch/csrc/gmm_quant.cu",
        "replaces": "automodel_tpu/ops/gmm_quant_kernel.py:182",
        "launches": moe_fp8["gmm_launches"]["gmm_quant"],
        "max_abs_err": max(c["max_abs_err"] for c in gq_cases),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "redesigned": "pack, then a wgmma + TMA persistent product",
        "pack_ms": rep["pack_ms"], "product_ms": rep["product_ms"],
        "two_pass_floor_ms": rep["two_pass_floor_ms"],
        "e4m3_ms": e4m3["ms"], "e4m3_library_ms": e4m3["library_ms"],
        "serve_moe_fp8_launches": serve_moe["fp8"]["run"][
            "gmm_quant_launches"],
        "generate_deepseek_fp8_launches": gen_deepseek["fp8"]["launches"][
            "gmm_quant"],
    })
    # a decode step's and a prefill chunk's groups (serve_moe_fp8)
    for c in serve_moe["gmm_quant_cases"]:
        kernels[-1].update({
            f"{c['case']}_ms": c["ms"], f"{c['case']}_plain_ms": c["plain_ms"],
            f"{c['case']}_bound_ms": c["bound_ms"],
            f"{c['case']}_bound_by": c["bound_by"],
            f"{c['case']}_library_ms": c["library_ms"]})
        kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                         c["max_abs_err"])
    for part, launches in (("fwd", sft_flash["fwd_launches"]),
                           ("bwd", sft_flash["bwd_launches"])):
        rep = flash_cases[0][part]
        causal = causal_case(flash_cases)[part]
        kernels.append({
            "name": f"flash_mha_{part}", "route": "cuda",
            "source": f"automodel_tpu_torch/csrc/flash_mha_{part}.cu",
            "replaces": "automodel_tpu/ops/flash_attention.py:66",
            "launches": launches,
            "max_abs_err": max(c[part]["max_abs_err"] for c in flash_cases),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "causal_ms": causal["ms"],
            "causal_library_ms": causal["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
