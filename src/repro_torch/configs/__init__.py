"""Architecture configs, one module per architecture
(``repro.configs``), the per-shape model adjustment, and the inputs of
each step as meta tensors for the dry run (``input_specs``, the
reference's ShapeDtypeStruct stand-ins).
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


def input_specs(model: ModelConfig, shape: InputShape,
                device="meta") -> dict:
    """Stand-ins for every input of the step function: the reference's
    dict, with tensors on ``device`` (meta: shapes and dtypes only) in
    place of its ShapeDtypeStructs.

    train  -> {"batch": {"tokens": (GB, S+1)} (+prefix/frames)}
    prefill-> {"batch": {"tokens": (GB, S)} (+prefix/frames)}
    decode -> {"tokens": (GB, 1), "cache": <init_cache shapes>}
    """
    import torch
    from repro_torch.models import model as M  # deferred: keep configs light

    model = model_for_shape(model, shape)
    gb, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = getattr(torch, model.act_dtype)

    def t(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    def extras(seq_tokens: int) -> dict:
        e = {}
        if model.arch_type == "vlm":
            p = min(model.num_prefix_tokens, seq_tokens // 2)
            e["prefix"] = t((gb, p, model.d_model), act)
        if model.arch_type == "audio":
            e["frames"] = t((gb, model.num_prefix_tokens, model.d_model), act)
        return e

    if shape.kind == "train":
        batch = {"tokens": t((gb, s + 1), i32), **extras(s)}
        if "prefix" in batch:  # vlm: prefix tokens count against the seq budget
            p = batch["prefix"].shape[1]
            batch["tokens"] = t((gb, s + 1 - p), i32)
        return {"batch": batch}

    if shape.kind == "prefill":
        batch = {"tokens": t((gb, s), i32), **extras(s)}
        if "prefix" in batch:
            p = batch["prefix"].shape[1]
            batch["tokens"] = t((gb, s - p), i32)
        return {"batch": batch}

    if shape.kind == "decode":
        cache = M.init_cache(model, gb, s, device=device)
        return {"tokens": t((gb, 1), i32), "cache": cache}

    raise ValueError(shape.kind)
