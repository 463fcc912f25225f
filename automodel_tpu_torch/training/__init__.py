"""Training loop pieces of the port (counterpart: ``automodel_tpu/training``)."""
