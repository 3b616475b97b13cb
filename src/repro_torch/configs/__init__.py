"""Architecture configs, one module per architecture
(``repro.configs``), and the per-shape model adjustment.

``input_specs``, which makes the reference's ShapeDtypeStruct stand-ins
for its XLA dry run, waits with ``launch/dryrun.py`` (ROADMAP queue 1,
item 3).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (  # noqa: F401
    ARCH_ALIASES,
    ARCH_IDS,
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    ModelConfig,
    ParallelConfig,
    load_arch,
    load_smoke,
    resolve_arch,
)

LONG_CONTEXT_WINDOW = 8192  # sliding-window size used for long_500k decode


def model_for_shape(model: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape model adjustments.

    long_500k on attention-bearing archs switches to the sliding-window
    variant (ring-buffer KV cache) -- full attention at 524288 would be
    quadratic/unbounded-memory; SSM archs are naturally O(1)-state.
    """
    if shape.name == "long_500k" and model.arch_type != "ssm" \
            and model.sliding_window == 0:
        model = dataclasses.replace(model, sliding_window=LONG_CONTEXT_WINDOW)
    return model
