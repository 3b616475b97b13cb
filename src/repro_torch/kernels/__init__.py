"""The MM-aggregation kernels, their launch plan, tuner and engine."""
