"""The VLM fine-tuning recipe."""
