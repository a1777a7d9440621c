"""The program under test, as the drivers build it: the port's
``ModelConfig`` from a configuration's file, its ``Model``, its kernels."""

from __future__ import annotations

import dataclasses


def config(conf: dict):
    """The port's registry entry ``conf["arch"]`` with every field of the
    file's ``model`` section set as written, so that the file is what runs.
    A section whose registry value is a dataclass (``moe``, ``ssm``) is that
    value with the section's keys set."""
    from repro_torch.configs import get_config

    base = get_config(conf["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    kw = {}
    for k, v in conf["model"].items():
        if k not in fields:
            raise KeyError(f"{conf['name']}: the port's ModelConfig has no field {k!r}")
        default = getattr(base, k)
        if dataclasses.is_dataclass(default):
            v = dataclasses.replace(default, **v)
        elif k in ("prefix_pattern", "pattern"):
            v = tuple(tuple(p) for p in v)
        kw[k] = v
    return dataclasses.replace(base, **kw)


def model(conf: dict, device):
    from repro_torch.models import Model
    from repro_torch.models.model import padded_vocab

    from .weights import padded_vocab as bench_padded_vocab

    cfg = config(conf)
    if padded_vocab(cfg) != bench_padded_vocab(conf["model"]):
        raise ValueError("the port pads the vocabulary otherwise than the benchmark's weights")
    return Model(cfg, device)


def build_kernels(device) -> None:
    """Build (or load from the checkout's build directory) the port's kernels."""
    if str(device).startswith("cuda"):
        from repro_torch.kernels import ops

        ops.build()
