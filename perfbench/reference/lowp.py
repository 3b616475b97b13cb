"""Rounding to a lower precision than a configuration states, for the
controls of the comparison that decides ``correct``.

``fp8`` rounds a tensor to float8 e4m3 under one per-tensor scale (its
largest magnitude to 448, the format's largest value) and back, with a
straight-through gradient: the value is rounded, the gradient passes as
it is, as in training with fp8 matmul operands.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(t.detach().abs().amax().float(), min=1e-30) / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def identity(t: torch.Tensor) -> torch.Tensor:
    return t
