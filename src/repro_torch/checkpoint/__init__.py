"""Pytree checkpoints in the reference's npz format (``repro.checkpoint``)."""
