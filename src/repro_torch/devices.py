"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Asking for CUDA where there is no card raises: the port
never carries on on the CPU unless the caller asked for it.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
