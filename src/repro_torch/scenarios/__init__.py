"""Scenario subsystem of the port: one frozen spec -> one run.

    from repro_torch import scenarios
    res = scenarios.run(scenarios.ScenarioSpec(paradigm="diffusion",
                                               backend="pallas"))

``scenarios.substrate`` is not imported here: the runner registers the
``substrate`` paradigm with a lazy shim, so importing this package does
not pull the training stack (launch, models, optim).
"""

from repro_torch.scenarios import metrics, registry, spec  # noqa: F401
from repro_torch.scenarios.metrics import (  # noqa: F401
    attack_summary, breakdown_threshold, steady)
from repro_torch.scenarios.registry import (  # noqa: F401
    Lowering, get_paradigm, paradigm_names, register_paradigm)
from repro_torch.scenarios.runner import run  # noqa: F401
from repro_torch.scenarios.spec import (  # noqa: F401
    BACKENDS, LSQ_SUBSTRATE, PARADIGMS, SUBSTRATE_AGGREGATORS,
    ScenarioResult, ScenarioSpec)
