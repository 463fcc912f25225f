"""Greedy continuation scoring through the engine or ``generate()``
(counterpart: ``automodel_tpu/serving/eval.py``).

It takes the rows an SFT eval config produces (``input_ids`` plus
``labels`` with ``-100`` over the prompt, or unmasked rows split at a
fraction), greedy-generates each prompt's continuation through either the
dense ``generate()`` or the paged :class:`~automodel_tpu_torch.serving.
engine.DecodeEngine`, and scores the generated tokens against the gold
continuation.  Both routes are greedy over the same model, so their
scores are identical.  Data is local only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

CROSS_ENTROPY_IGNORE_IDX = -100


def split_prompt_target(row: Dict[str, Any], *, prompt_frac: float = 0.5
                        ) -> Optional[Tuple[List[int], List[int]]]:
    """``(prompt, gold continuation)`` from one dataset row.

    SFT-masked rows (hellaswag et al.): the prompt is every position whose
    label is the ignore index, the target the rest.  Labels are
    pre-shifted by one (``datasets/utils.py``), so the boundary in the
    pre-shifted labels at index ``i`` marks target start ``i + 1`` in
    ``input_ids``.  Unmasked rows (the mock datasets) split at
    ``prompt_frac``.  Rows too short to split return None.
    """
    ids = [int(t) for t in row["input_ids"]]
    labels = row.get("labels")
    if labels is not None and any(
            int(l) == CROSS_ENTROPY_IGNORE_IDX for l in labels):
        shifted = [int(l) for l in labels]
        try:
            first = next(i for i, l in enumerate(shifted)
                         if l != CROSS_ENTROPY_IGNORE_IDX)
        except StopIteration:
            return None
        cut = first + 1
    else:
        cut = max(1, int(len(ids) * prompt_frac))
    prompt, target = ids[:cut], ids[cut:]
    if not prompt or not target:
        return None
    return prompt, target


def rows_from_dataset(dataset, *, limit: Optional[int] = None,
                      prompt_frac: float = 0.5
                      ) -> List[Tuple[List[int], List[int]]]:
    out = []
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        split = split_prompt_target(dataset[i], prompt_frac=prompt_frac)
        if split is not None:
            out.append(split)
    return out


def _pad_batch(prompts: Sequence[List[int]], pad_id: int):
    B = len(prompts)
    S = max(len(p) for p in prompts)
    ids = np.full((B, S), pad_id, np.int32)
    lens = np.zeros((B,), np.int32)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
        lens[b] = len(p)
    return ids, lens


def greedy_continuation_score(
        model, rows: Sequence[Tuple[List[int], List[int]]], *,
        via: str = "engine", max_new_tokens: Optional[int] = None,
        serving=None, generation=None, device=None) -> Dict[str, Any]:
    """Greedy-generate every row's continuation and score it against the
    gold target: per-row fraction of matched target tokens, plus exact
    match.  ``via`` is ``"engine"`` (the paged decode engine) or
    ``"generate"`` (the dense eval path), the same score by construction.
    ``device`` (default ``cuda``) is where the model runs.
    """
    from automodel_tpu_torch.generation.generate import (
        GenerationConfig,
        generate,
    )
    from automodel_tpu_torch.utils.device import resolve_device

    if via not in ("engine", "generate"):
        raise ValueError(f"via must be 'engine' or 'generate', got {via!r}")
    if not rows:
        raise ValueError("no scoreable rows")
    horizon = max_new_tokens or max(len(t) for _, t in rows)
    gen = generation or GenerationConfig()
    cfg = GenerationConfig(
        max_new_tokens=horizon, do_sample=False,
        eos_token_id=gen.eos_token_id, pad_token_id=gen.pad_token_id)
    ids, lens = _pad_batch([p for p, _ in rows], cfg.pad_token_id)

    device = resolve_device(device)
    if via == "engine":
        from automodel_tpu_torch.serving.engine import (
            DecodeEngine,
            ServingConfig,
        )

        scfg = serving or ServingConfig(
            max_model_len=int(max(lens)) + horizon,
            max_num_seqs=min(len(rows), 8))
        toks = DecodeEngine(model, scfg, generation=cfg,
                            device=device).generate(ids, lens, cfg)
    else:
        toks = generate(model.to(device), ids, prompt_lens=lens, config=cfg)

    match = []
    exact = []
    for b, (_, target) in enumerate(rows):
        t = np.asarray(target[:horizon], np.int32)
        got = np.asarray(toks[b, :len(t)], np.int32)
        match.append(float(np.mean(got == t)))
        exact.append(bool((got == t).all()))
    return {
        "score": float(np.mean(match)),
        "exact_match": float(np.mean(exact)),
        "rows": len(rows),
        "via": via,
        "tokens": toks,
    }


def eval_config_dataset(cfg, model, *, via: str = "engine",
                        section: str = "validation_dataset",
                        limit: Optional[int] = 16,
                        max_new_tokens: Optional[int] = None,
                        serving=None, device=None,
                        **instantiate_kwargs) -> Dict[str, Any]:
    """Score a loaded eval YAML's dataset section through ``via``: its
    dataset node instantiates to SFT-masked or unmasked rows from local
    data (pass ``tokenizer=...`` through ``instantiate_kwargs`` for nodes
    that take it out of band, as the recipes do)."""
    node = cfg.get(section) if hasattr(cfg, "get") else None
    if node is None:
        raise ValueError(f"config has no {section!r} section")
    dataset = (node.instantiate(**instantiate_kwargs)
               if hasattr(node, "instantiate") else node)
    rows = rows_from_dataset(dataset, limit=limit)
    return greedy_continuation_score(
        model, rows, via=via, max_new_tokens=max_new_tokens,
        serving=serving, device=device)
