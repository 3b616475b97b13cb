"""The port's entry points, one module for each of the reference's
examples (``examples/*.py``) that needs nothing beyond the port:

    python -m repro_torch.examples.quickstart          # on the card
    python -m repro_torch.examples.quickstart --device cpu

``quickstart``, ``federated``, ``scenario_sweep``, ``serve_agg``,
``serve_lm`` and ``train_robust_lm`` run the reference's specs and sizes
and print its headlines; each takes ``--device`` (default ``cuda``).
"""
