"""The port's model configuration for a benchmark configuration file,
held to the file's numbers, and the size of a payload.

The file names the port's configuration (``port_config``) and its model
family (``family``); ``families/<family>.py`` maps the file's keys onto
the port's ``ModelConfig`` fields (``FIELDS``)."""

from __future__ import annotations

import dataclasses

from harness.common import RunError


def model_config(conf: dict, fam):
    """The port's ModelConfig as the file states it (its depth the
    file's ``num_hidden_layers``); a field the port holds otherwise
    than ``fam.FIELDS`` maps it ends the run.  ``port_variant:
    "smoke"`` takes the port's reduced same-family variant (the CPU
    tests' configurations)."""
    from repro_torch import configs
    if conf.get("port_variant") == "smoke":
        cfg = configs.load_smoke(conf["port_config"])
    else:
        cfg = configs.load_arch(conf["port_config"]).model
    cfg = dataclasses.replace(cfg, num_layers=conf["num_hidden_layers"])
    for key, field in fam.FIELDS.items():
        if getattr(cfg, field) != conf[key]:
            raise RunError(2, f"the port's {field} is {getattr(cfg, field)!r}, "
                              f"the configuration states {key} = {conf[key]!r}")
    return cfg


def leaf_shapes(cfg) -> dict:
    """{dotted leaf name: shape} of the port's parameter tree."""
    from repro_torch import pytree
    from repro_torch.launch import steps
    tree = steps.param_template(cfg)
    names = pytree.leaf_paths(tree)
    leaves = pytree.flatten(tree)[0]
    return {n: tuple(t.shape) for n, t in zip(names, leaves)}


def payload_size(conf: dict, fam) -> int:
    """Coordinates in one client's update: the whole model, one decoder
    layer, or the number the file states (``coordinates``)."""
    kind = conf["payload"]
    if kind == "coordinates":
        return int(conf["parameters"])
    shapes = leaf_shapes(model_config(conf, fam))
    if kind == "model":
        m = sum(_numel(s) for s in shapes.values())
    elif kind == "decoder_layer":
        m = sum(_numel(s[1:]) for n, s in shapes.items()
                if n.startswith("blocks."))
    else:
        raise RunError(2, f"unknown payload {kind!r}")
    if m != conf["parameters"]:
        raise RunError(2, f"a {kind} payload has {m} coordinates, the "
                          f"configuration states {conf['parameters']}")
    return m


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
