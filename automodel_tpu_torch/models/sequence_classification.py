"""Sequence classification on a causal-LM backbone (counterpart:
``automodel_tpu/models/sequence_classification.py``).

HF's ``*ForSequenceClassification``: the decoder backbone without its
``lm_head`` plus a bias-free ``score`` head ``[num_labels, H]``, applied to
the hidden state of each row's last non-pad token.  That token is found as
the JAX ``_last_token_index`` finds it: from the padding mask (its sum
minus one), else from ``pad_token_id`` (the first pad minus one, wrapped
to ``S - 1`` when a row has none: HF's modulo trick), else the last
position.  The JAX tree is ``{"backbone": <the backbone's tree without
lm_head>, "score": {"kernel": [H, num_labels]}}``; the HF key map re-roots
the backbone's map (``models/hf_io.py``) and reads a ``score`` head that a
causal-LM directory lacks as a fresh one, as HF does.  A hidden-state loss
(``FusedLinearCrossEntropy``) is refused: the logits are ``[B,
num_labels]`` and go to ``MaskedCrossEntropy`` with one label per row.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.weights import jax_leaves


class ForSequenceClassification(nn.Module):
    """Wraps a backbone built by ``models/auto_model.py`` (its ``lm_head``
    dropped) with a ``score`` head."""

    def __init__(self, backbone: nn.Module, num_labels: int,
                 pad_token_id: Optional[int] = None):
        super().__init__()
        backbone.lm_head = None
        self.backbone = backbone
        self.config = backbone.config
        self.num_labels = int(num_labels)
        self.pad_token_id = pad_token_id
        self.compute_dtype = backbone.compute_dtype
        self.param_dtype = backbone.param_dtype
        self.score = nn.Linear(self.config.hidden_size, self.num_labels,
                               bias=False, dtype=backbone.param_dtype,
                               device=backbone.embed_tokens.weight.device)

    serving_refusal = ("a sequence classifier has no decode path: it "
                       "scores rows through the recipe")

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ForSequenceClassification":
        """The backbone's init from ``seed``, then :meth:`init_score`."""
        self.backbone.init_weights(seed)
        return self.init_score(seed)

    @torch.no_grad()
    def init_score(self, seed: int = 0) -> "ForSequenceClassification":
        """The head N(0, 0.02) from a generator seeded ``seed + 1``."""
        gen = torch.Generator(device=self.score.weight.device).manual_seed(
            seed + 1)
        self.score.weight.normal_(0.0, 0.02, generator=gen)
        return self

    @property
    def remat_policy(self):
        """The backbone's remat policy (read and set through the
        wrapper)."""
        return self.backbone.remat_policy

    @remat_policy.setter
    def remat_policy(self, value):
        self.backbone.remat_policy = value

    @property
    def checkpoint_dir(self):
        return getattr(self.backbone, "checkpoint_dir", None)

    @checkpoint_dir.setter
    def checkpoint_dir(self, value):
        self.backbone.checkpoint_dir = value

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        for path, target, transposed in jax_leaves(self.backbone):
            yield ("backbone",) + path, target, transposed
        yield ("score", "kernel"), self.score.weight, True

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        return self.backbone.flops_per_token()

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        return self.backbone.attention_flops_per_token(seq_len, causal)

    def last_token_index(self, input_ids: torch.Tensor,
                         attention_mask: Optional[torch.Tensor]
                         ) -> torch.Tensor:
        """Each row's pooled position ``[B]`` (the JAX
        ``_last_token_index``)."""
        B, S = input_ids.shape
        if attention_mask is not None:
            return attention_mask.to(torch.int64).sum(-1) - 1
        if self.pad_token_id is not None:
            is_pad = (input_ids == self.pad_token_id).to(torch.int64)
            first_pad = is_pad.argmax(-1)
            has_pad = is_pad.any(-1)
            return torch.where(has_pad, first_pad - 1,
                               torch.full_like(first_pad, S - 1)) % S
        return torch.full((B,), S - 1, dtype=torch.int64,
                          device=input_ids.device)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                return_hidden: bool = False, **kwargs
                ) -> Dict[str, torch.Tensor]:
        """``input_ids [B, S]`` -> ``{"logits": [B, num_labels]}`` in the
        compute dtype (and the backbone's ``aux_loss`` when it has one)."""
        if return_hidden:
            raise ValueError(
                "sequence classification has no lm_head: fused-linear-CE "
                "losses (needs_hidden=True) are incompatible -- configure "
                "loss_fn: MaskedCrossEntropy")
        if kwargs.get("kv_cache") is not None:
            raise NotImplementedError(self.serving_refusal)
        out = self.backbone(input_ids, position_ids=position_ids,
                            segment_ids=segment_ids,
                            attention_mask=attention_mask,
                            return_hidden=True, **kwargs)
        hidden = out["hidden_states"]
        idx = self.last_token_index(input_ids, attention_mask)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        idx]
        result = {"logits": F.linear(pooled,
                                     self.score.weight.to(self.compute_dtype))}
        if "aux_loss" in out:
            result["aux_loss"] = out["aux_loss"]
        return result
