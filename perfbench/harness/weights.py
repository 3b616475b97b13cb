"""The benchmark's model weights, made on the device from the seed.

One ``normal_`` call fills a buffer with every random coordinate; each
leaf then takes its slice, scaled by its family's rule
(``families/<family>.py`` ``init_rule``, the architecture's usual
initialisation), in float32, the type the parameters are held in.  Both
the program and the reference are handed these tensors (or the same ones
made again).
"""

from __future__ import annotations

import torch


def make(shapes: dict, seed: int, device, rule) -> dict:
    """{dotted name: f32 tensor} for {dotted name: shape}; ``rule(name,
    shape)`` is ("const", value) or ("normal", std)."""
    rules = {n: rule(n, s) for n, s in shapes.items()}
    total = sum(_numel(s) for n, s in shapes.items()
                if rules[n][0] == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.empty((total,), dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    out, off = {}, 0
    for name, shape in shapes.items():
        kind, value = rules[name]
        if kind == "const":
            out[name] = torch.full(shape, value, dtype=torch.float32,
                                   device=device)
        else:
            n = _numel(shape)
            out[name] = buf[off:off + n].view(shape) * value
            off += n
    return out


def nest(flat: dict) -> dict:
    """The dotted names as the nested dict of the port's tree."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
