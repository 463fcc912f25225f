"""Data path of the port (counterpart: ``automodel_tpu/datasets``)."""
