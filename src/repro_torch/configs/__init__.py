"""Experiment configurations (the paper's Sec. 4 problem)."""
