"""The dense, MoE and VLM decoder transformers (``repro.models``)."""
