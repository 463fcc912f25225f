"""LLM recipes of the port (counterpart: ``automodel_tpu/recipes/llm``)."""
