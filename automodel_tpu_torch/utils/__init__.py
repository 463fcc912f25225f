"""Shared helpers of the port (counterpart: ``automodel_tpu/utils``)."""
