"""Parameter-efficient fine-tuning (counterpart: ``automodel_tpu/peft``)."""
