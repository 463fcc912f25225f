"""PyTorch / CUDA port of ``automodel_tpu``.

The package mirrors the JAX package's layout module for module (each
module's docstring names its counterpart) and runs on an NVIDIA Hopper
card.  It imports ``torch`` and never ``jax`` or ``automodel_tpu``; the
JAX package is the reference the port's tests hold it against.

What it covers today: the serving path (``serving.engine.DecodeEngine``
over a block-paged KV cache, with the paged-decode attention kernel
written by hand in CUDA C++, ``csrc/paged_decode.cu``) and the Llama SFT
path (``recipes.llm.train_ft`` with the masked cross-entropy loss, with the
training attention forward and backward written by hand in CUDA C++,
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``).
"""
