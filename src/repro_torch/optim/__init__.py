"""Hand-written optimizers (``repro.optim``)."""
