"""Optimizers and schedules of the port (counterpart: ``automodel_tpu/optim``)."""
