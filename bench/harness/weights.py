"""Model weights made from a seed, on the device, in the port's parameter layout.

The benchmark makes the weights itself and hands the same tensors to the
program; the reference makes them again from the same seed, one group at a
time, so that it never reads what the program holds.  A group is the head
(embedding, final norm, LM head) or one layer: ``norm1``, its mixer's
leaves, ``norm2``, its FFN's, each kind's as ``bench/layers/<kind>.py``
lists them.  Each group is drawn from a generator of its own, seeded from
``(seed, group)``, in two calls: one ``randn`` in the model's dtype for all
of its model-dtype leaves, one in fp32 for its fp32 leaves (the MoE
router), each leaf a view of that draw, scaled in place.

The layout is the port's (``repro_torch.models.model``): ``embed [Vp, d]``
(also the LM head when tied), ``final_norm.w``, ``lm_head.w [d, Vp]``, and
``layers[i]`` with ``norm1.w``, ``mixer`` (attention's ``{q,k,v,o}.w``),
``norm2.w`` and ``ffn`` (a dense MLP's ``{gate,up,down}.w``; a MoE FFN's
``router.w [d, E]`` (fp32), ``gate``/``up [E, d, d_e]``, ``down [E, d_e, d]``
and ``shared.{gate,up,down}.w``).  Linear weights are
``N(0, 1/d_in)``; norm weights (the norm scales by ``1 + w``) are
``N(0, NORM_STD^2)``.  The vocabulary's rows are padded to a multiple of
``VOCAB_PAD``, as the port pads them.
"""

from __future__ import annotations

import math

import torch

from bench import layers
from bench.counts.flops import layer_seq  # noqa: F401  (the metrics read it from here)

VOCAB_PAD = 256
NORM_STD = 0.1
_MASK = (1 << 64) - 1


def mix(seed: int, i: int) -> int:
    """A 63-bit generator seed from ``(seed, i)`` (splitmix64)."""
    x = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) & _MASK
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def padded_vocab(m: dict) -> int:
    return -(-m["vocab"] // VOCAB_PAD) * VOCAB_PAD


def model_dtype(m: dict) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[m["dtype"]]


def group_leaves(m: dict, g: int) -> list[tuple[tuple, tuple, float, bool]]:
    """``(path, shape, std, fp32)`` of each leaf of group ``g``: 0 is the
    head, ``1 + i`` layer ``i``."""
    d = m["d_model"]
    if g == 0:
        vp = padded_vocab(m)
        out = [(("embed",), (vp, d), 1 / math.sqrt(d), False), (("final_norm", "w"), (d,), NORM_STD, False)]
        if not m.get("tied_embeddings", False):
            out.append((("lm_head", "w"), (d, vp), 1 / math.sqrt(d), False))
        return out
    mixer, ffn = layer_seq(m)[g - 1]
    return [(("norm1", "w"), (d,), NORM_STD, False), *_below(m, "mixer", mixer),
            (("norm2", "w"), (d,), NORM_STD, False), *_below(m, "ffn", ffn)]


def _below(m: dict, part: str, kind: str) -> list[tuple[tuple, tuple, float, bool]]:
    """The leaves of layer kind ``kind`` under ``part`` (``mixer`` or ``ffn``)."""
    return [((part, *path), shape, std, fp32) for path, shape, std, fp32 in layers.load(kind).leaves(m)]


def _put(tree: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def make_group(m: dict, g: int, seed: int, device) -> dict:
    """Group ``g``'s leaves as a nested dict, drawn from ``(seed, g)``."""
    leaves = group_leaves(m, g)
    gen = torch.Generator(device=device).manual_seed(mix(seed, g))
    out: dict = {}
    for fp32 in (False, True):
        part = [lf for lf in leaves if lf[3] == fp32]
        if not part:
            continue
        n = sum(math.prod(shape) for _, shape, _, _ in part)
        dtype = torch.float32 if fp32 else model_dtype(m)
        flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
        at = 0
        for path, shape, std, _ in part:
            size = math.prod(shape)
            _put(out, path, flat[at : at + size].view(shape).mul_(std))
            at += size
    return out


def make_params(m: dict, seed: int, device) -> dict:
    """Every group, assembled in the port's layout."""
    params = make_group(m, 0, seed, device)
    params["layers"] = [make_group(m, 1 + i, seed, device) for i in range(m["n_layers"])]
    return params


def flatten(tree, prefix: tuple = ()) -> list[tuple[str, torch.Tensor]]:
    """``[(path, leaf)]`` with dict keys sorted and lists by index; the path
    joins them with ``/``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def unflatten(paths: list[str], leaves: list) -> dict:
    """The nested dict (lists where a key is an index) that :func:`flatten`
    would turn into ``zip(paths, leaves)``."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        _put(tree, tuple(path.split("/")), leaf)
    return _lists(tree)


def _lists(tree):
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_lists(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}
