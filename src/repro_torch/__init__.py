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
    the same two names; on the card the service launches each cohort by
    replaying a CUDA graph captured once per cohort geometry.

  * ``make_train_step_gspmd`` (``launch.steps``): the reference's Mode A
    train step, with ``device`` in place of its mesh; its K agents run
    one after another on the card and its parameters are the
    reference's stacked leaves (``models.model.Model``).

Entry points take ``device`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.  Random draws go
through explicit ``torch.Generator`` objects seeded from the spec.
Every paradigm of the reference, ``sharded`` included, and every model
family (dense, moe, vlm, ssm, hybrid, audio) runs in the port.
"""
