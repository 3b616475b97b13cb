"""PyTorch/CUDA port of the robust-aggregation system for NVIDIA Hopper.

The package mirrors ``repro`` (the JAX reference) file for file:
``repro/core/location.py`` pairs with ``repro_torch/core/location.py``.
It imports torch, numpy and the standard library, never ``jax`` or
``repro``; only the tests import both.

Names kept from the reference, and what they mean here:

  * aggregator ``"mm_pallas"`` and engine backend ``"pallas"``: the
    hand-written Hopper kernels in ``kernels/csrc`` (their plain PyTorch
    versions when the tensors lie on the CPU);
  * backend ``"jnp"``: the plain PyTorch estimator of ``core.location``;
  * ``ScenarioSpec`` fields and values: one spec means the same run in
    both packages, with different random streams.

  * ``ServeConfig.backend`` of the streaming service (``serve/``) takes
    the same two names, and its ``interpret`` field (the reference's
    Pallas interpret switch) has no effect; on the card the service
    launches each cohort by replaying a CUDA graph captured once per
    cohort geometry.

Entry points take ``device`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.  Random draws go
through explicit ``torch.Generator`` objects seeded from the spec.
Paradigms not ported yet (``sharded``, ``substrate``) raise
``NotImplementedError``.
"""
