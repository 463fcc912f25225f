"""Quantized training compute (counterpart: ``automodel_tpu/quantization``)."""
