"""Gemma-2 text family (counterpart: ``automodel_tpu/models/gemma2.py``).

The Gemma-3 decoder of ``models/gemma3.py`` minus the q / k norms and plus
logit soft-capping, both config branches of the shared body:

* ``attn_logit_softcapping`` (50.0): the tanh cap on the attention
  scores, compiled into kernel 9 on the card;
* ``final_logit_softcapping`` (30.0): the tanh cap on the head's logits,
  so only a logits loss (``MaskedCrossEntropy``) trains it; a hidden-state
  loss raises, as in JAX;
* one rope base for sliding and full layers (``rope_local_base_freq`` is
  pinned to ``rope_theta``);
* alternating layers, sliding first (HF's Gemma-2 order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from automodel_tpu_torch.models.gemma3 import Gemma3Config, Gemma3ForCausalLM


@dataclasses.dataclass
class Gemma2Config(Gemma3Config):
    """HF ``Gemma2Config`` field names on the shared Gemma superset."""

    qk_norm: bool = False
    attn_logit_softcapping: float = 50.0
    final_logit_softcapping: float = 30.0
    rope_theta: float = 10_000.0

    def __post_init__(self):
        if self.layer_types is None:
            # HF Gemma-2: even layers sliding, odd layers full
            self.layer_types = [
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(self.num_hidden_layers)]
        super().__post_init__()
        self.rope_local_base_freq = self.rope_theta
        self.model_type = "gemma2"

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Gemma2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in hf.items() if k in known}
        kwargs.pop("rope_local_base_freq", None)   # derived from rope_theta
        kwargs.pop("qk_norm", None)                # not a Gemma-2 concept
        return cls(**kwargs)


class Gemma2ForCausalLM(Gemma3ForCausalLM):
    """The shared Gemma decoder with the soft caps on and the q / k norms
    off."""
