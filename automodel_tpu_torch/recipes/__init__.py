"""Training recipes of the port (counterpart: ``automodel_tpu/recipes``)."""
