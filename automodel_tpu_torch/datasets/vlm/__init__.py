"""VLM datasets, processors and collators (counterpart: ``automodel_tpu/datasets/vlm``)."""
