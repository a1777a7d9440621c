"""Sharding policy: param / batch / cache PartitionSpecs per architecture.

The port of ``repro.launch.sharding``.  Megatron-style TP on the ``model``
axis:

* attention: Q/K/V column-parallel (output dim), O row-parallel (input dim);
* MLP: gate/up column-parallel, down row-parallel;
* MoE: expert-parallel — the leading expert axis shards on ``model``;
* Mamba: in_proj/conv column-parallel on d_inner, x_proj/out_proj
  row-parallel;
* embeddings / LM head: vocab-parallel (vocab is padded to a multiple of
  256, so it always divides);
* sLSTM: replicated;
* batch: sharded over ``("pod", "data")`` when divisible; a batch of one
  shards the KV-cache *sequence* axis instead (SP).

Every rule guards on divisibility, so the same policy serves full configs,
smoke variants and degraded meshes.  ``_param_rule``, ``_cache_rule`` and
``_div`` are the reference's, rule for rule and in its order.

The rules match on the reference's leaf **paths** (``decoder/body/0/mixer/
q/w``).  The port's trees are unstacked, one dict a layer
(:mod:`repro_torch.models.convert`), so :func:`param_specs` and
:func:`cache_specs` walk the port's tree and name each leaf by the path its
layer has in the reference: layer ``i`` of ``layers`` is
``decoder/prefix/i`` below ``len(prefix_pattern)``, else
``decoder/body/j`` with ``j = (i - len(prefix)) % len(pattern)``, and every
layer of ``enc_layers`` is ``encoder/body/0``.  A layer's spec is the
reference's inner spec, without the leading ``None`` of the stacked axis.
The functions read only shapes, so a tree of ``device="meta"`` tensors will
do.

A spec is a :class:`PartitionSpec` of the port's own (``P(*parts)``; a part
is ``None``, an axis name, or a tuple of names such as ``("pod", "data")``).
:func:`to_shardings` turns specs into DTensor placements on a
``DeviceMesh``, and :func:`distribute_params` places a tree of params with
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch._bridge import tree_flatten_with_path, tree_map, tree_unflatten
from repro_torch.models.config import ModelConfig

from .mesh import Mesh, axis_names, axis_size, data_axes

PyTree = Any


class PartitionSpec:
    """``P(*parts)``: for each tensor dim, ``None``, an axis name or a tuple
    of axis names.  A leaf of a tree (not a tuple, so tree maps stop here);
    ``tuple(spec)`` gives its parts, and it equals a spec or a tuple of the
    same parts."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(tuple(p) if isinstance(p, list) else p for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        return isinstance(other, tuple) and self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 else f"P({self._parts[0]!r})"


P = PartitionSpec


def _div(n: int, mesh: Mesh, axes) -> bool:
    return n % axis_size(mesh, axes) == 0 and n >= axis_size(mesh, axes)


def _param_rule(path: str, shape: tuple[int, ...], mesh: Mesh) -> P:
    """PartitionSpec for one *unstacked* param leaf (no repeats dim)."""
    m = "model"

    def col(in_dim_idx: int = 0) -> P:
        # column-parallel: shard the LAST dim
        parts = [None] * len(shape)
        if _div(shape[-1], mesh, m):
            parts[-1] = m
        return P(*parts)

    def row() -> P:
        # row-parallel: shard the FIRST dim
        parts = [None] * len(shape)
        if _div(shape[0], mesh, m):
            parts[0] = m
        return P(*parts)

    leaf = path.rsplit("/", 1)[-1]

    if "embed" == path or path.endswith("/embed") or path == "embed":
        return row()  # [Vp, d] vocab-parallel
    if "lm_head" in path:
        return col() if leaf == "w" else row()
    if "/router/" in path or path.endswith("router/w") or path.endswith("router/b"):
        return P(*([None] * len(shape)))  # tiny, replicate
    if "/ffn/" in path and len(shape) == 3:
        # MoE expert stacks [E, d, de] / [E, de, d] — expert-parallel
        parts = [None] * len(shape)
        if _div(shape[0], mesh, m):
            parts[0] = m
        return P(*parts)
    if any(k in path for k in ("/g_i/", "/g_f/", "/g_z/", "/g_o/")):
        return P(*([None] * len(shape)))  # sLSTM cell: replicated
    if any(k in path for k in ("i_gate", "f_gate")):
        return P(*([None] * len(shape)))  # [d, H] — H small
    if "norm" in path:
        return P(*([None] * len(shape)))  # all norms replicated
    if leaf in ("b",) and len(shape) == 1:
        # biases follow their matrix: column-parallel ones shard
        if any(k in path for k in ("/o/", "down", "out_proj", "x_proj")):
            return P(None)  # row-parallel output bias is replicated
        return P(m) if _div(shape[0], mesh, m) else P(None)
    if any(k in path for k in ("/q/", "/k/", "/v/", "gate/", "up/", "in_proj", "dt_proj", "vision_proj")):
        return col()
    if any(k in path for k in ("/o/", "down/", "out_proj", "x_proj")):
        return row()
    if "conv_w" in path:  # [dc, di]
        return col()
    if "conv_b" in path or path.endswith("/D"):
        return P(m) if _div(shape[0], mesh, m) else P(None)
    if "A_log" in path:  # [di, ds]
        return row()
    # norms, scalars, anything else: replicate
    return P(*([None] * len(shape)))


def layer_paths(cfg: ModelConfig, n_layers: int, stack: str = "decoder") -> list[str]:
    """The reference's path of each of ``n_layers`` unstacked layers of
    ``stack``: ``decoder/prefix/i`` or ``decoder/body/j`` (the arithmetic of
    ``convert._stack``); every encoder layer is ``encoder/body/0``."""
    if stack == "encoder":
        return ["encoder/body/0"] * n_layers
    n_pre, n_pat = len(cfg.prefix_pattern), len(cfg.pattern)
    return [f"{stack}/prefix/{i}" if i < n_pre else f"{stack}/body/{(i - n_pre) % n_pat}"
            for i in range(n_layers)]


def _reference_paths(tree: PyTree, cfg: ModelConfig, layer_keys: dict[str, str]) -> list[tuple[str, Any]]:
    """``[(reference path, leaf)]`` over the port's tree in its leaf
    order: a leaf under ``layer_keys[k]/i/...`` is renamed by its layer."""
    renamed = {key: layer_paths(cfg, len(tree[key]), stack) for key, stack in layer_keys.items() if key in tree}
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        head, _, rest = path.partition("/")
        if head in renamed:
            i, _, inner = rest.partition("/")
            path = f"{renamed[head][int(i)]}/{inner}"
        out.append((path, leaf))
    return out


_PARAM_LAYERS = {"layers": "decoder", "enc_layers": "encoder"}


def param_specs(cfg: ModelConfig, params_shape: PyTree, mesh: Mesh) -> PyTree:
    """PartitionSpec tree matching the port's params (anything with
    ``.shape`` as leaves): each leaf gets the reference's spec of its path,
    a layer's without the stacked axis."""
    specs = [_param_rule(p, tuple(leaf.shape), mesh)
             for p, leaf in _reference_paths(params_shape, cfg, _PARAM_LAYERS)]
    return tree_unflatten(params_shape, specs)


def batch_specs(cfg: ModelConfig, batch_shape: PyTree, mesh: Mesh) -> PyTree:
    """Token/label/frontend inputs: batch over ("pod","data")."""
    dp = data_axes(mesh)

    def rule(leaf):
        shape = tuple(leaf.shape)
        parts = [None] * len(shape)
        if shape and _div(shape[0], mesh, dp):
            parts[0] = dp if len(dp) > 1 else dp[0]
        return P(*parts)

    return tree_map(rule, batch_shape)


def _cache_rule(
    path: str, shape: tuple[int, ...], cfg: ModelConfig, mesh: Mesh,
    *, optimized: bool = True,
) -> P:
    dp = data_axes(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]
    m = "model"
    leaf = path.rsplit("/", 1)[-1]
    parts: list = [None] * len(shape)
    if not shape:
        return P()
    batch_shardable = _div(shape[0], mesh, dp)

    if leaf in ("k", "v") and len(shape) == 4:
        # [B, M, Hkv, hd]
        if optimized:
            # H3: shard the cache SEQUENCE over `model`.
            if batch_shardable:
                parts[0] = dp_spec
                if _div(shape[1], mesh, m):
                    parts[1] = m
            elif _div(shape[1], mesh, dp + (m,)):
                parts[1] = dp + (m,)  # batch=1 long-context: full SP
            return P(*parts)
        if batch_shardable:
            parts[0] = dp_spec
        elif _div(shape[1], mesh, ("data",)) and "data" in axis_names(mesh):
            parts[1] = "data"  # SP: batch=1 long-context → shard sequence
        if _div(shape[2], mesh, m):
            parts[2] = m
        elif _div(shape[3], mesh, m):
            parts[3] = m
        return P(*parts)
    if leaf == "conv":  # [B, dc-1, di]
        if batch_shardable:
            parts[0] = dp_spec
        if _div(shape[-1], mesh, m):
            parts[-1] = m
        return P(*parts)
    if leaf == "ssm":  # [B, di, ds]
        if batch_shardable:
            parts[0] = dp_spec
        if _div(shape[1], mesh, m):
            parts[1] = m
        return P(*parts)
    if leaf == "enc_out":  # [B, S, d]
        if batch_shardable:
            parts[0] = dp_spec
        return P(*parts)
    # recurrent xLSTM states & scalars: shard batch if possible, else replicate
    if batch_shardable:
        parts[0] = dp_spec
    return P(*parts)


def cache_specs(
    cfg: ModelConfig, cache_shape: PyTree, mesh: Mesh, *, optimized: bool = True
) -> PyTree:
    """PartitionSpec tree matching the port's cache (``{"len", "layers",
    "enc_out"?}``, from ``Model.init_cache``); layer ``i`` is named by its
    reference path under ``decoder``."""
    specs = [_cache_rule(p, tuple(leaf.shape), cfg, mesh, optimized=optimized)
             for p, leaf in _reference_paths(cache_shape, cfg, {"layers": "decoder"})]
    return tree_unflatten(cache_shape, specs)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``, as ``jax.sharding.NamedSharding``:
    :attr:`placements` holds, for each mesh dim, ``Shard(i)`` where that
    dim's name is ``spec[i]`` or is in it, else ``Replicate()``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(self.mesh)
        out: list = [Replicate()] * len(names)
        for i, part in enumerate(self.spec):
            axes = () if part is None else (part,) if isinstance(part, str) else tuple(part)
            dims = [names.index(a) for a in axes]
            # DTensor shards one tensor dim over several mesh dims in mesh
            # order; JAX in the order of the compound part.
            if dims != sorted(dims):
                raise ValueError(f"compound part {part!r} is not in the mesh's axis order {names}")
            for k in dims:
                out[k] = Shard(i)
        return tuple(out)


def to_shardings(mesh, specs: PyTree) -> PyTree:
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def distribute_params(params: PyTree, specs: PyTree, mesh) -> PyTree:
    """``params`` (as ``params_from_jax`` returns them, on any device) placed
    on ``mesh`` leaf by leaf with ``distribute_tensor`` and the placements
    of ``specs``; each leaf is a leaf DTensor that requires grad as its
    tensor did."""
    from torch.distributed.tensor import distribute_tensor

    shardings = tree_flatten_with_path(to_shardings(mesh, specs))
    leaves = tree_flatten_with_path(params)
    if [n for n, _ in shardings] != [n for n, _ in leaves]:
        raise ValueError("the specs do not match the params' tree")
    out = []
    for (_, s), (_, t) in zip(shardings, leaves):
        out.append(distribute_tensor(t.detach(), mesh, s.placements).requires_grad_(t.requires_grad))
    return tree_unflatten(params, out)


def redistribute_like(tree: PyTree, like: PyTree) -> PyTree:
    """Each DTensor leaf of ``tree`` redistributed to the placements of the
    leaf of ``like`` at its place.  Autograd leaves a parameter's gradient
    as DTensor's propagation placed it: over the data ranks a partial sum
    (the gradient that data parallelism has yet to all-reduce), and along
    the param's dims sharded as the backward's last op left it.  This is the
    all-reduce, and it places the gradients as their params."""
    placed = [t.redistribute(ref.device_mesh, ref.placements)
              for (_, t), (_, ref) in zip(tree_flatten_with_path(tree), tree_flatten_with_path(like), strict=True)]
    return tree_unflatten(tree, placed)
