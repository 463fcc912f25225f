"""Generation utilities of the port (counterpart: ``automodel_tpu/generation``)."""

from automodel_tpu_torch.generation.generate import (  # noqa: F401
    GenerationConfig,
    generate,
    sample_logits,
)
