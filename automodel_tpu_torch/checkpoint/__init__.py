"""Checkpointing (counterpart: ``automodel_tpu/checkpoint/``)."""
