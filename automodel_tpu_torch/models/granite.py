"""IBM Granite (HF ``model_type: granite``; counterpart:
``automodel_tpu/models/granite.py``).

The Llama decoder of ``models/llama.py`` plus four scalar multipliers, set
on the decoder's hooks as in JAX:

* ``embedding_multiplier`` on the token embeddings;
* ``attention_multiplier`` in place of ``head_dim ** -0.5``: it reaches
  kernel 9's ``scale`` (and the decode kernel's);
* ``residual_multiplier`` on both block outputs before the residual add;
* ``logits_scaling`` dividing the logits, folded into the head operand of
  the linear-CE kernels on a hidden-state loss (a tied head's gradient
  carries the factor).

The key map is Llama's: Granite's deltas are scalars, not tensors.
"""

from __future__ import annotations

import dataclasses

from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM


@dataclasses.dataclass
class GraniteConfig(LlamaConfig):
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "granite"


class GraniteForCausalLM(LlamaForCausalLM):
    """``model_type: granite``: Llama with the four multipliers."""

    def __init__(self, config: GraniteConfig, **kwargs):
        super().__init__(config, **kwargs)
        self._embedding_scale = float(config.embedding_multiplier)
        self._residual_scale = float(config.residual_multiplier)
        self._attn_softmax_scale = float(config.attention_multiplier)
        self._logits_divisor = float(config.logits_scaling)
