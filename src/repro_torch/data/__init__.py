"""Synthetic data for the linear-model experiments."""
