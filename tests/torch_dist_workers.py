"""The per-rank bodies of the port's multi-rank tests (imported by the
spawned ranks: nothing here imports JAX)."""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_YAML = os.path.join(REPO, "examples", "llm_finetune",
                        "tiny_llama_mock.yaml")


def _setup_with_weights(recipe, weights):
    """``setup()`` with the model filled from the JAX recipe's initial
    weights before the plan shards it."""
    from automodel_tpu_torch.models import weights as W
    from automodel_tpu_torch.recipes.llm import train_ft

    orig = train_ft.load_pretrained_weights

    def load(model, peft):
        W.load_jax_params(model, weights)
        orig(model, peft)

    train_ft.load_pretrained_weights = load
    try:
        recipe.setup()
    finally:
        train_ft.load_pretrained_weights = orig


def mesh_layout(rank, world, cases):
    """Each case's ``(coordinate, {axes: group ranks})`` on this rank."""
    import torch.distributed as dist

    from automodel_tpu_torch.distributed.mesh import MeshManager

    out = []
    for case in cases:
        mm = MeshManager(**case)
        groups = {}
        for axes in (("cp",), ("tp",), ("dp_shard", "cp"),
                     ("dcn_dp", "dp_replicate", "dp_shard", "cp")):
            groups[axes] = dist.get_process_group_ranks(mm.group(axes))
        out.append((mm.coordinate(), groups))
    return out


def signals_and_timers(rank, world):
    """Rank 2 alone receives the trapped signal: every rank's
    ``signals_received`` must see it; each rank's timer holds ``rank``
    seconds: the gathered stats must be over all ranks."""
    from automodel_tpu_torch.training.timers import Timers
    from automodel_tpu_torch.utils.sig_utils import DistributedSignalHandler

    with DistributedSignalHandler() as h:
        before = h.signals_received()
        if rank == 2:
            h._received = True
        after = h.signals_received()
    timers = Timers()
    timers("step").add(float(rank))
    stats = timers.get_global_elapsed(["step", "absent"], reset=True)
    return before, after, stats, ranked_seeds()


def ranked_seeds():
    """``ranked: true`` seeds on this rank: on one host (no node rank), and
    as the second host's would be (torchrun's ``GROUP_RANK=1``)."""
    from automodel_tpu_torch.training.rng import StatefulRNG

    one_host = StatefulRNG(seed=1111, ranked=True)
    os.environ["GROUP_RANK"] = "1"
    try:
        second = StatefulRNG(seed=1111, ranked=True)
    finally:
        del os.environ["GROUP_RANK"]
    return ((one_host._effective_seed, one_host.seed_for(0)),
            (second._effective_seed, second.seed_for(0)))


RING_B, RING_S, RING_HQ, RING_HK, RING_D = 2, 32, 4, 2, 16


def ring_inputs(seed, segments):
    """q, k, v, dout ``[B, S, H, D]`` fp32 and packed segment ids (or
    None), in the original token order, from a numpy seed."""
    rng = np.random.default_rng(seed)
    B, S, Hq, Hk, D = RING_B, RING_S, RING_HQ, RING_HK, RING_D
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    seg = None
    if segments:
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(2, S - 4), 3, replace=False))
            for i, (a, z) in enumerate(zip([0, *cuts], [*cuts, S - 3])):
                seg[b, a:z] = i + 1          # the last 3 rows are padding
    return q, k, v, dout, seg


def ring_cases(rank, world, cases):
    """Each case's port ring attention on this rank: ``(rows, cp index,
    out, dq, dk, dv)`` of its shard (numpy)."""
    import torch

    from automodel_tpu_torch.distributed.mesh import MeshManager
    from automodel_tpu_torch.distributed.shardings import process_batch_rows
    from automodel_tpu_torch.ops.ring_attention import sharded_ring_attention
    from automodel_tpu_torch.ops.zigzag import zigzag_permute

    out = []
    for case in cases:
        mm = MeshManager(cp_layout=case["layout"], **case["mesh"])
        q, k, v, dout, seg = ring_inputs(case["seed"], case["segments"])
        if case["layout"] == "zigzag":
            q, k, v, dout = (zigzag_permute(x, mm.cp_size, axis=1)
                             for x in (q, k, v, dout))
            seg = None if seg is None else zigzag_permute(seg, mm.cp_size)
        rows = process_batch_rows(mm, RING_B)
        c = mm.index(("cp",))
        n = RING_S // mm.cp_size

        def local(x):
            return torch.from_numpy(
                np.ascontiguousarray(x[rows][:, c * n:(c + 1) * n]))

        tq, tk, tv = (local(x).requires_grad_() for x in (q, k, v))
        o = sharded_ring_attention(
            tq, tk, tv, mm, segment_ids=None if seg is None else local(seg),
            layout=case["layout"],
            local_window_size=case.get("window"),
            logits_soft_cap=case.get("cap"))
        o.backward(local(dout))
        out.append((rows, c, o.detach().numpy(), tq.grad.numpy(),
                    tk.grad.numpy(), tv.grad.numpy()))
    return out


CE_B, CE_S, CE_H = 4, 16, 32


def ce_inputs(seed, V):
    """hidden [B, S, H], head [H, V], labels [B, S] (some ignored) and
    per-token loss weights, fp32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(CE_B, CE_S, CE_H)).astype(np.float32)
    w = (rng.normal(size=(CE_H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (CE_B, CE_S)).astype(np.int32)
    labels[rng.random((CE_B, CE_S)) < 0.2] = -100
    wgt = rng.random((CE_B, CE_S)).astype(np.float32)
    return h, w, labels, wgt


def vocab_ce_cases(rank, world, cases):
    """Each case's port ``_sharded_lse_pick`` on this rank: ``(rows, tp
    index, per-token loss, dh, dW of the local vocab slice)``."""
    import torch

    from automodel_tpu_torch.distributed.mesh import MeshManager
    from automodel_tpu_torch.distributed.shardings import process_batch_rows
    from automodel_tpu_torch.loss.linear_ce import _sharded_lse_pick
    from automodel_tpu_torch.distributed.tensor_parallel import TPContext
    import torch.distributed as dist

    out = []
    for case in cases:
        mm = MeshManager(**case["mesh"])
        h, w, labels, wgt = ce_inputs(case["seed"], case["V"])
        rows = process_batch_rows(mm, CE_B)
        t = mm.index(("tp",))
        vl = case["V"] // mm.tp_size
        group = mm.group(("tp",))
        tp = TPContext(group=group, size=mm.tp_size,
                       rank=dist.get_rank(group))
        th = torch.from_numpy(h[rows]).requires_grad_()
        tw = torch.from_numpy(np.ascontiguousarray(
            w[:, t * vl:(t + 1) * vl])).requires_grad_()
        tok = _sharded_lse_pick(th, tw, torch.from_numpy(labels[rows]), tp)
        (tok * torch.from_numpy(wgt[rows])).sum().backward()
        out.append((rows, t, tok.detach().numpy(), th.grad.numpy(),
                    tw.grad.numpy()))
    return out


def tp_model_grads(rank, world, cases):
    """A tiny Llama over dp 2 x tp 2 with the fused linear CE: the loss
    and every parameter's whole gradient, per case (tied or untied head,
    sequence parallelism on or off)."""
    import torch

    from automodel_tpu_torch.distributed.mesh import MeshManager
    from automodel_tpu_torch.distributed.shardings import (
        build_parallel_plan,
        process_batch_rows,
    )
    from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy

    out = []
    for case in cases:
        model, batch = tp_model_and_batch(case)
        mm = MeshManager(dp_size=2, tp_size=2,
                         sequence_parallel=case["sp"])
        plan = build_parallel_plan(model, mm)
        plan.apply(model)
        rows = process_batch_rows(mm, batch["input_ids"].shape[0])
        ids = torch.from_numpy(batch["input_ids"][rows])
        labels = torch.from_numpy(batch["labels"][rows])
        n = plan.sum_over_loss_group((labels != -100).sum().float())
        with plan.context():
            o = model(ids, return_hidden=True)
            loss = FusedLinearCrossEntropy()(o["hidden_states"],
                                             o["lm_head_kernel"], labels)
        (loss / n).backward()
        named = {k: p.grad for k, p in model.named_parameters()}
        plan.reduce_partial_grads(named)
        grads = {k: plan.full_tensor(k, p, local=p.grad.to_local()).numpy()
                 for k, p in model.named_parameters()}
        out.append((float(plan.sum_over_loss_group(loss.detach()) / n),
                    grads))
    return out


def tp_model_and_batch(case):
    """The tiny Llama of a ``tp_model_grads`` case (fp32, seeded) and its
    batch ``{input_ids, labels}`` [4, 16]; ``granite`` builds a Granite
    (a subclass that keeps Llama's decoder) with its four multipliers."""
    from automodel_tpu_torch.models.granite import (
        GraniteConfig,
        GraniteForCausalLM,
    )
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    kw = dict(vocab_size=200, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, tie_word_embeddings=case["tied"])
    if case.get("granite"):
        cfg, cls = GraniteConfig(
            embedding_multiplier=6.0, attention_multiplier=0.2,
            residual_multiplier=0.5, logits_scaling=4.0, **kw), \
            GraniteForCausalLM
    else:
        cfg, cls = LlamaConfig(**kw), LlamaForCausalLM
    model = cls(cfg, param_dtype="float32", compute_dtype="float32",
                device="cpu")
    model.init_weights(seed=case["seed"])
    rng = np.random.default_rng(case["seed"])
    ids = rng.integers(0, 200, (4, 16)).astype(np.int64)
    labels = rng.integers(0, 200, (4, 16)).astype(np.int64)
    labels[:, :3] = -100
    return model, {"input_ids": ids, "labels": labels}


MOE_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                        "tiny_qwen3_moe_sft.yaml")
NANOGPT_YAML = os.path.join(REPO, "examples", "llm_pretrain",
                            "nanogpt_pretrain.yaml")


def pretrain_recipe(file_pattern, steps=2):
    """The nanoGPT YAML at a tiny GPT-2 (fp32, no checkpoint) over the
    shards at ``file_pattern``."""
    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    cfg = parse_args_and_load_config(
        ["-c", NANOGPT_YAML, "--device", "cpu", "--model.n_embd", "64",
         "--model.n_layer", "2", "--model.n_head", "4",
         "--model.vocab_size", "512", "--model.n_positions", "128",
         "--model.compute_dtype", "float32", "--dataset.seq_len", "128",
         "--dataset.file_pattern", file_pattern,
         "--step_scheduler.max_steps", str(steps),
         "--checkpoint.enabled", "false"])
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return [{k: m[k] for k in ("step", "loss", "grad_norm",
                               "num_label_tokens")} for m in recipe.history]


def full_state(recipe):
    """The recipe's whole parameters ``{name: tensor}`` and optimizer state
    dict (gathered over the mesh when there is one: collective)."""
    plan = recipe.plan
    if plan is None:
        params = {n: p.detach().clone()
                  for n, p in recipe.model.named_parameters()}
    else:
        with plan.full_params(recipe.model) as fulls:
            params = {n: t.clone() for n, t in fulls.items()}
    return params, recipe.optimizer.state_dict()


def _recipe(overrides, yaml=JAX_YAML):
    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    cfg = parse_args_and_load_config(
        ["-c", yaml, "--device", "cpu", "--dataloader.prefetch_depth", "0",
         "--model.config.torch_dtype", "float32",
         "--model.compute_dtype", "float32", *overrides])
    return train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)


def recipe_suite(rank, world, spec):
    """Every multi-rank recipe case in one group of ranks: the trajectory
    of each mesh in ``spec["meshes"]`` from the JAX recipe's weights, a
    save at dp 2 x tp 2 (its whole state after the save), a resume of the
    world-1 checkpoint at dp 2 x tp 2 (its whole state after set-up), and
    the refusals under a mesh (exception class and message)."""
    out = {"runs": {}, "refusals": {}}
    steps = ["--step_scheduler.max_steps", str(spec["steps"]),
             "--checkpoint.enabled", "false"]
    for name, over in spec["meshes"].items():
        recipe = _recipe(steps + over)
        _setup_with_weights(recipe, spec["weights"])
        recipe.run_train_validation_loop()
        out["runs"][name] = {
            "history": [{k: m[k] for k in ("step", "loss", "grad_norm",
                                           "num_label_tokens", "lr")}
                        for m in recipe.history],
            "val": list(recipe.val_history)}
    mesh = spec["save_mesh"]
    ck = ["--checkpoint.enabled", "true", "--checkpoint.checkpoint_dir"]
    recipe = _recipe(["--step_scheduler.max_steps", "2",
                      "--step_scheduler.ckpt_every_steps", "2",
                      *ck, spec["save_dir"], *mesh])
    _setup_with_weights(recipe, spec["weights"])
    recipe.run_train_validation_loop()
    recipe.join_pending_save()
    out["saved"] = full_state(recipe) if rank == 0 else None
    if rank != 0:
        full_state(recipe)
    recipe = _recipe(["--step_scheduler.max_steps", "4", *ck,
                      spec["resume_dir"], *mesh])
    recipe.setup()
    state = full_state(recipe)
    out["resumed"] = state if rank == 0 else None
    out["pretrain"] = pretrain_recipe(spec["shards"])
    for name, (yaml, over) in spec["refusals"].items():
        try:
            _recipe(over, yaml).setup()
            out["refusals"][name] = None
        except Exception as e:   # noqa: BLE001 - the refusal is the result
            out["refusals"][name] = (type(e).__name__, str(e))
    return out
