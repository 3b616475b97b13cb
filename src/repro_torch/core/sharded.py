"""Aggregator resolution for the train steps (``repro.core.sharded``).

Only ``engine_aggregator`` is ported: the one resolution path that Mode A
of the train steps, the substrate scenarios and (later) the collectives
share.  The collectives themselves (``gather_mm``, ``rs_mm``,
``hier_mm``, ``robust_all_reduce``) over ``torch.distributed`` are
ROADMAP queue 1, item 2.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

from repro_torch.core import aggregators

# MM-family names and the engine backend each defaults to: ``mm_pallas``
# launches the Hopper kernels (their plain versions on CPU tensors),
# ``mm_tukey`` / ``ref`` run the plain PyTorch estimator
_ENGINE_BACKENDS = {"mm_tukey": "jnp", "ref": "jnp", "mm_pallas": "pallas"}


def engine_aggregator(aggregator="mm_tukey", *, backend: Optional[str] = None,
                      **kwargs) -> Callable:
    """Resolve an aggregator name to a ``(stacked, a) -> estimate`` fn.

    MM-family names route through the one engine entry point
    (``kernels.ops.mm_aggregate``); ``backend`` overrides the name's
    default (``mm_tukey`` -> jnp, ``mm_pallas`` -> pallas).  Other names
    come from the core registry unchanged.
    """
    if isinstance(aggregator, str):
        default_backend = _ENGINE_BACKENDS.get(aggregator)
        if default_backend is not None:
            from repro_torch.kernels import ops  # deferred: avoid import cycle
            b = backend or default_backend

            def agg(x, a, _backend=b, _kw=kwargs):
                return ops.mm_aggregate(x, a, backend=_backend, **_kw)

            return agg
        return aggregators.get_aggregator(aggregator, **kwargs)
    return functools.partial(aggregator, **kwargs) if kwargs else aggregator
