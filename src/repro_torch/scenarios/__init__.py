"""Scenario subsystem of the port: one frozen spec -> one run.

    from repro_torch import scenarios
    res = scenarios.run(scenarios.ScenarioSpec(paradigm="diffusion",
                                               backend="pallas"))
"""

from repro_torch.scenarios import metrics, registry, spec  # noqa: F401
from repro_torch.scenarios.metrics import steady  # noqa: F401
from repro_torch.scenarios.runner import run  # noqa: F401
from repro_torch.scenarios.spec import (  # noqa: F401
    BACKENDS, PARADIGMS, ScenarioResult, ScenarioSpec)
