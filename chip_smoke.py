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
   MHA head_dim-128 case of the Pallas flash kernel; then the flash rung's
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
   serve_moe: Qwen3-30B-A3B at its published widths and all 48 layers
   (``qwen3_30b_a3b_serve.yaml``, ~61 GB of bf16 weights) through the same
   engine phase: first the gmm kernel at the engine's routed shapes (a
   decode step's 64 assignments and a prefill chunk's 2048 over 128
   experts, block-padded), the first step through every kernel against
   every plain version, the 16 requests with paged decode held to layers
   x steps and gmm to 3 x layers x steps, profiled windows, then the
   prefix cache on and off (tokens identical);
   serve_qwen2: Qwen2.5-1.5B-Instruct's published config at all 28 layers
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
   torch.matmul and bound times (``qdot_case`` lines), then the fp8
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
   ckpt: the same YAML with ``--checkpoint.enabled true`` (a temporary
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
   (the attention phase above also holds kernel 9 at head_dim 192 on the
   V2-Lite YAML's first batch, ``mla_*_d192``, v padded with zeros, and
   the paged-decode phase Qwen3's G 8 decode and verify, ``qwen3_*``);
12. the JAX package's HF fine-tuning YAMLs as written
   (``examples/llm_finetune/qwen3/qwen3_0p6b_hellaswag.yaml``, phase
   sft_qwen3_hellaswag, and ``llama3_2/llama3_2_1b_squad.yaml``, phase
   sft_llama_squad): each model's published config at all its layers with
   random bf16 weights as an ``HF_HOME`` snapshot under the repo id the
   YAML names, seeded rows in the set's schema as local jsonl, and
   :class:`ByteTokenizer` by ``tokenizer._target_`` (the only overrides,
   with the step count and the checkpoint directory): the loaded weights
   bit for bit as written, kernel 9 at the model's heads on the first
   batch's rows and (Qwen3's V 151,936) kernels 2-4 at its labels against
   their plain versions, the first step against every plain version, the
   exact launch counts over the steps and the validation passes, step
   time, MFU, peak memory, the validation loss and a profiled window;
13. quant_check: qdot kernel against qdot plain through a 2-layer Llama at
   sft_fp8's widths on the bench YAML's first batch, attention plain on
   both sides, int8 (bit for bit) and float8 (limits set from a measured
   run), loss and whole gradient (``quant_check_* first step`` lines).

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

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
]
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
    to MB * BS = 2048 (row 0 full), consecutive positions ending at ctx-1."""
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
        q, k, v, ks, vs, tables, ctx, pos = make_paged_case(S, D, kv, seed=i,
                                                            Hq=Hq, Hk=Hk)
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
    boolean mask): ``(run_fwd, run_bwd, to_bshd)``.  A yardstick only; the
    port never calls it."""
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
    must then come out exactly 0."""
    import torch

    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import make_attention_mask

    dev = torch.device("cuda")
    rows = []
    for i, (name, B, S, Hq, Hk, D, packed, win, cap) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
        k = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
        v = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
        if v_dim is not None:
            v[..., v_dim:] = 0
        dout = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
        seg = (torch.from_numpy(seg_np[:B, :S]).to(dev).contiguous()
               if packed else None)
        kw = dict(causal=True, segment_ids=seg, logits_soft_cap=cap,
                  local_window_size=win)
        mask = make_attention_mask(S, S, causal=True, segment_ids_q=seg,
                                   segment_ids_kv=seg,
                                   local_window_size=win, device=dev)
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
                q, k, v, dout, mask, not packed and win is None, D ** -0.5)
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
        row = dict(case=name, B=B, S=S, Hq=Hq, Hk=Hk, D=D, packed=packed,
                   window=win, soft_cap=cap, attended_pairs=pairs,
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
]
LCE_PARTS = ("dlogits", "dh", "dw")


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


def lce_case(name, T, H, V, kind, bench_labels, flush, seed, parts):
    """One linear-CE case: kernels against plain versions on the card,
    then the times; ``parts`` also times each backward kernel alone."""
    import torch
    import torch.nn.functional as F

    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(T, H, device=dev, generator=g).bfloat16()
    ws = (torch.randn(V, H, device=dev, generator=g) * 0.02).bfloat16()
    w = ws.t()                     # the model's [H, V] view of [V, H]
    if kind == "bench":
        labels = torch.from_numpy(bench_labels.reshape(-1)).to(dev).int()
        check(labels.numel() == T, f"{name}: {labels.numel()} labels != {T}")
    elif kind == "random":
        labels = torch.randint(0, V, (T,), device=dev, generator=g,
                               dtype=torch.int32)
    else:
        labels = torch.full((T,), -100, dtype=torch.int32, device=dev)
    valid = (labels != -100).float()
    dlse, dpick = valid, -valid          # the summed loss's cotangents

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
        return F.cross_entropy(F.linear(h, ws).float(), lab64,
                               ignore_index=-100, reduction="sum")

    ref_loss = float((valid * (ref_lse - ref_pick)).sum())
    lib_loss = float(lib_fwd())
    check(abs(lib_loss - ref_loss) <= 1e-2 * max(abs(ref_loss), 1.0),
          f"{name}: the library yardstick computes something else "
          f"({lib_loss} vs {ref_loss})")
    t["fwd_library"] = time_ms(lib_fwd, 3, flush)
    hl, wl = h.detach().requires_grad_(), ws.detach().requires_grad_()
    out = F.cross_entropy(F.linear(hl, wl).float(), lab64, ignore_index=-100,
                          reduction="sum")
    t["bwd_library"] = time_ms(
        lambda: torch.autograd.grad(out, (hl, wl), retain_graph=True), 3,
        flush)
    del out, hl, wl
    torch.cuda.empty_cache()

    bounds = lce_bounds(T, H, V)
    row = dict(case=name, T=T, H=H, V=V, labels=kind,
               valid_rows=int(valid.sum()),
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
                             seed=200 + i, parts=i == 0))
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
            return out.float()
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
def engine_phase(yaml_path=None, label="engine", flush=None, model=None):
    """A model at full width through the port's DecodeEngine (the serve
    YAML ``yaml_path``, default Llama-3.2-1B's; weights from seed 0, or
    ``model`` as given, built by the caller): the
    first step's logits through every kernel against every plain version,
    16 requests of 64-1024 prompt tokens after a warm-up with the counts
    zeroed just before and read just after (paged decode = layers x steps;
    gmm = 3 x routed layers x steps for an MoE model, else 0), then
    profiled prefill and decode windows.  Llama: a shorter int8-KV run
    too.  An MoE model: first the gmm kernel at the engine's routed
    shapes (``flush`` given), last the prefix cache on and off."""
    import gc

    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        RequestState,
        build_serving_config,
    )

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = load_yaml_config(yaml_path or SERVE_YAML)
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
    gmm_rows = []
    if moe:
        E, inter = moe_widths(model)
        for i, (name, tokens) in enumerate(SERVE_GMM_CASES):
            padded, n_pad = seeded_routing_sizes(
                tokens, E, mcfg.num_experts_per_tok, 400 + i)
            gmm_rows.append(gmm_case(name, padded, n_pad, mcfg.hidden_size,
                                     inter, flush, seed=410 + i))
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

    def drive(serving, requests, max_new, run):
        eng = DecodeEngine(model, serving, generation=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pak.launches = 0                  # counts zeroed just before the run
        tpa.long_q_gather_calls = 0
        gk.gmm_launches = 0
        t0 = time.perf_counter()
        for p in requests:
            eng.submit(p, max_new_tokens=max_new)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, gathers, gmms = (pak.launches, tpa.long_q_gather_calls,
                                   gk.gmm_launches)
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
        check(gmms == routed * st["steps"] == eng.gmm_launches,
              f"{run}: {gmms} gmm launches (engine {eng.gmm_launches}) != "
              f"{routed} x {st['steps']} steps")
        check(gathers == 0, f"{run}: {gathers} long-query gather calls")
        check(bool(torch.isfinite(eng.last_logits).all()),
              f"{run}: non-finite logits")
        report = dict(
            run=run, requests=len(requests), max_new_tokens=max_new,
            decode_tok_s=st["tokens_generated"] / wall, wall_s=wall,
            steps=st["steps"], decode_steps=st["decode_steps"],
            mixed_steps=st["mixed_steps"], kernel_launches=launches,
            launches_per_step=launches / st["steps"], gmm_launches=gmms,
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
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return main


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
        return [int(np.argmax(a != b)) if (a != b).any() else None
                for a, b in zip(out[a_run], out[b_run])]

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
    del model
    gc.collect()
    torch.cuda.empty_cache()
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
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((dev_us / 1e3 / steps, evt.count / steps,
                            evt.key[:80]))
    kernels.sort(reverse=True)
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
def first_step_check(recipe, label, routes, compare, quantized=False,
                     rows=2, limits=None, floor_route="kernel_again"):
    """Loss and whole gradient of the first step (``rows`` rows of the
    first batch, the recipe's initial weights) through each route ``(name,
    loss_fn, attn_impl[, gmm_impl[, qdot_impl[, remat_policy]]])`` (the
    grouped matmuls', the quantized projections' routes and the model's
    remat policy, else its own); nothing is updated.  Each pair
    in ``compare`` must agree (``quantized``: the gradient within the
    quantized limit, derived from the run's own floor) within the loss and
    gradient limits, or within ``limits`` ``(loss_tol, grad_tol)`` where
    given.  ``kernel_again`` (a second kernel pass) shows the run-to-run
    spread (0 when every kernel of the route is deterministic); the floor
    is the kernel route against ``floor_route``, two equally right
    computations (by default ``kernel_again``).  Returns the printed
    report."""
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
        [{k: v[:rows] for k, v in first.items()}], recipe.device).items()}
    losses, grads = {}, {}
    for name, loss_fn, attn_impl, *impls in routes:
        if hasattr(model, "gmm_impl"):        # the MoE models' experts
            model.gmm_impl = impls[0] if impls else None
        model.qdot_impl = impls[1] if len(impls) > 1 else None
        model.remat_policy = (resolve_remat_policy(impls[2])
                              if len(impls) > 2 else own_policy)
        model.zero_grad(set_to_none=True)
        loss = microbatch_loss(model, loss_fn, mb, attn_impl=attn_impl)
        loss.backward()
        torch.cuda.synchronize()
        losses[name] = float(loss.detach())
        grads[name] = [p.grad for _, p in trained]
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
               loss_tol=SFT_LOSS_REL_TOL,
               grad_tol=SFT_GRAD_REL_L2,
               grad_rel_l2_kernel_vs_kernel=rel_l2("kernel_again",
                                                   "kernel")[0],
               floor_route=floor_route,
               grad_rel_l2_floor=rel_l2(floor_route, "kernel")[0])
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


def train_phase(label, yaml_path, overrides=(), bf16=None, attn_impl=None,
                first_step=None, sync_report=False):
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
    the synchronizing calls it makes."""
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
    L = mcfg.num_hidden_layers
    fused = isinstance(recipe.loss_fn, FusedLinearCrossEntropy)
    is_moe = hasattr(recipe.model, "gmm_impl")
    quant = recipe.model.quant
    quantized = quant is not None and quant.enabled
    peft = recipe.peft_config
    ffn = (f"{moe_widths(recipe.model)[0]} experts of "
           f"{moe_widths(recipe.model)[1]}, top-{mcfg.num_experts_per_tok}"
           f" in {moe_layer_count(recipe.model)} layers" if is_moe
           else str(mcfg.intermediate_size))
    print(f"{label}: {type(recipe.model).__name__} widths (vocab "
          f"{mcfg.vocab_size}, hidden {mcfg.hidden_size}, ffn {ffn}, layers "
          f"{L}, heads {mcfg.num_attention_heads}/"
          f"{mcfg.num_key_value_heads}, head_dim {mcfg.head_dim}), "
          f"{sum(p.numel() for p in recipe.model.parameters())} params "
          f"{recipe.model.param_dtype}, remat {recipe.model.remat_policy}, "
          f"quantized compute {quant if quantized else 'off'}, "
          f"loss {type(recipe.loss_fn).__name__}, attention "
          f"{attn_impl or 'splash'}, loader "
          f"{type(recipe.dataloader).__name__}, "
          f"set up in {time.perf_counter() - t0:.1f} s", flush=True)
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
    return report


# ---------------------------------------------------------------------------
# ckpt phase
# ---------------------------------------------------------------------------
CKPT_SAVES = 1          # per mode: inline, then asynchronous


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
    """The bench YAML at full width with checkpointing on (``keep_last_k``
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
                ["-c", BENCH_YAML, "--checkpoint.enabled", "true",
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


def write_hf_model(hf_home, repo_id):
    """Write the published config and random bf16 weights from ``seed``
    (biases too, away from 0) as the ``refs/main`` snapshot of
    ``repo_id`` under ``hf_home`` (``save_hf_weights``, then the published
    ``config.json``; the seed is ``HF_SEEDS[repo_id]``); returns ``(snapshot dir, the written tensors that
    the phase checks, on the host)``."""
    import torch

    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import AutoModelForCausalLM

    cfg, seed = HF_CONFIGS[repo_id], HF_SEEDS[repo_id]
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
              if n in ("model.embed_tokens.weight", "model.norm.weight",
                       "model.layers.0.self_attn.q_proj.weight",
                       "model.layers.0.self_attn.k_norm.weight",
                       f"model.layers.{L - 1}.mlp.down_proj.weight")
              or n.endswith("_proj.bias")]
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
        check(t.dtype == want.dtype and bool(torch.equal(t, want)),
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
    snap, written = write_hf_model(hf_home, repo_id)
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
          f"{mcfg.intermediate_size}, layers {L}, heads "
          f"{mcfg.num_attention_heads}/{mcfg.num_key_value_heads}, head_dim "
          f"{mcfg.head_dim}, qk_norm {mcfg.qk_norm}), {model.num_params} "
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
    """Qwen2.5-1.5B-Instruct at its published config and all 28 layers
    (q / k / v biases, G 6, the window fields off), written as an
    ``HF_HOME`` snapshot and loaded by ``AutoModelForCausalLM.
    from_pretrained(..., load_weights=True)``: every q / k / v bias and a
    sample of the other tensors bit for bit as written, then the engine
    phase (``qwen2_5_1p5b_serve.yaml``'s serving: first-step logits
    kernel against plain, the 16 requests with paged decode held to 28 x
    steps, profiled windows), then n-gram speculation on and off (the
    verify width, S 5) on periodic prompts with the same launch gate and
    the same tokens."""
    import numpy as np
    import torch

    from automodel_tpu_torch.models.auto_model import AutoModelForCausalLM

    repo_id = "Qwen/Qwen2.5-1.5B-Instruct"
    snap, written = write_hf_model(hf_home, repo_id)
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
    lite_seg = first_batch(LITE_YAML)["segment_ids"]
    bench_first = first_batch(BENCH_YAML)
    bench_labels = bench_first["labels"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = kernel_phase(flush)
    phase_done("paged_decode kernel")
    lora_cases = lora_gmm_phase(flush)
    phase_done("lora gmm kernel")
    attn_cases = attention_phase(flush, seg)
    mla_cases = attention_phase(flush, lite_seg, MLA_CASES, MLA_V_HEAD_DIM)
    phase_done("attention kernels")
    flash_cases = flash_phase(flush, bench_first["segment_ids"])
    phase_done("flash kernels")
    lce_cases = linear_ce_phase(flush, bench_labels)
    phase_done("linear-CE kernels")
    q_cases = qdot_phase(flush)
    phase_done("qdot kernel")
    main_run = engine_phase()
    phase_done("engine")
    torch.cuda.empty_cache()
    features = serving_features_phase()
    phase_done("serving_features")
    torch.cuda.empty_cache()
    serve_moe = engine_phase(MOE_SERVE_YAML, "serve_moe", flush)
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
    kernels[-1]["serve_moe_launches"] = serve_moe["kernel_launches"]
    kernels[-1]["serve_qwen2_launches"] = serve_qwen2["kernel_launches"]
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
    lce_cases = lce_cases + [r["lce_case"] for r in hf_runs.values()
                             if r["lce_case"] is not None]
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
    })
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
    })
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
