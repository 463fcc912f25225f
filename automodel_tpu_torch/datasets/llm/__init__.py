"""LLM datasets of the port (counterpart: ``automodel_tpu/datasets/llm``)."""
