"""Losses of the port (counterpart: ``automodel_tpu/loss``)."""
