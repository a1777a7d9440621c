"""The port's sharding specs (``repro_torch.launch.sharding``,
``repro_torch.optim.zero``) against the reference's, for every arch.

Shapes come from the reference's ``jax.eval_shape`` trees; the port's trees
are those trees unstacked (through ``params_from_jax``) into
``device="meta"`` tensors, so nothing is allocated (qwen1.5-110b alone is
222 GB).  Each leaf is compared by its reference path, each spec as a tuple
of axis names: a layer's spec is the reference's inner spec (its stacked
spec without the leading ``None``).  The meshes are the reference's
``AbstractMesh`` and the port's, at the production ``(16, 16)`` and
``(2, 16, 16)`` and a degraded ``(4, 8)``.

``to_shardings`` is held to the placements of a ``DeviceMesh``: for each
mesh dim ``Shard(i)`` where its name is (in) ``spec[i]``, else
``Replicate()``; the ``(2, 16, 16)`` mesh of 512 ranks is made in one
process on the ``"fake"`` process group.
"""

from datetime import timedelta

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES
from repro.launch import sharding as jsh
from repro.launch.steps import input_specs
from repro.models import Model as JModel
from repro.optim.zero import _augment as jaugment
from repro.optim.zero import zero1_specs as jzero1
from repro_torch._bridge import tree_flatten_with_path, tree_map
from repro_torch.configs import get_config as tget
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import AbstractMesh, axis_size, data_axes
from repro_torch.models import Model, params_from_jax
from repro_torch.optim import zero1_specs

MESHES = {
    "pod1": ((16, 16), ("data", "model")),
    "pod2": ((2, 16, 16), ("pod", "data", "model")),
    "degraded": ((4, 8), ("data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(sizes, names):
    try:
        return JAbstractMesh(sizes, names)
    except TypeError:  # older jax takes (name, size) pairs
        return JAbstractMesh(tuple(zip(names, sizes)))


def _meshes(name):
    sizes, names = MESHES[name]
    return _jmesh(sizes, names), AbstractMesh(sizes, names)


def _parts(spec) -> tuple:
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p for p in spec)


def _jflat(tree) -> dict:
    """``{reference path: leaf}`` of a reference tree of specs or shapes."""
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]
    return {jsh._path_str(p): leaf for p, leaf in flat}


def _meta(jtree):
    return jax.tree.map(lambda s: torch.empty(tuple(s.shape), device="meta"), jtree)


@pytest.fixture(scope="module")
def trees():
    """arch → (reference params shape tree, the port's meta params tree)."""
    out = {}
    for arch in sorted(ARCHS):
        jshape = jax.eval_shape(JModel(jget(arch)).init, jax.random.key(0))
        out[arch] = (jshape, params_from_jax(_meta(jshape), tget(arch), "meta"))
    return out


def _port_by_ref_path(cfg, tree, layer_keys) -> list[tuple[str, object]]:
    """``[(reference path, leaf)]`` of the port's tree (its layers renamed)."""
    paths = {key: tsh.layer_paths(cfg, len(tree[key]), stack) for key, stack in layer_keys.items() if key in tree}
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        head, _, rest = path.partition("/")
        if head in paths:
            i, _, inner = rest.partition("/")
            path = f"{paths[head][int(i)]}/{inner}"
        out.append((path, leaf))
    return out


def _held(cfg, jspecs, jshapes, tspecs, tshapes, layer_keys):
    """Every port leaf's spec equals the reference's at its path (inner
    spec for a stacked layer), over the same shapes; every reference path
    is reached."""
    jsp, jsh_ = _jflat(jspecs), _jflat(jshapes)
    tsp = _port_by_ref_path(cfg, tspecs, layer_keys)
    tshp = dict(_port_by_ref_path(cfg, tshapes, layer_keys))
    assert len(tsp) == len(tree_flatten_with_path(tshapes))
    for path, spec in tsp:
        stacked = "/body/" in f"/{path}/"
        want, shape = _parts(jsp[path]), tuple(jsh_[path].shape)
        if stacked:
            assert want[0] is None, (path, want)
            want, shape = want[1:], shape[1:]
        assert tuple(tshp[path].shape) == shape, path
        assert _parts(spec) == want, (path, spec, want)
    assert {p for p, _ in tsp} == set(jsp)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh, trees):
    jmesh, tmesh = _meshes(mesh)
    jshape, tshape = trees[arch]
    cfg = tget(arch)
    jspecs = jsh.param_specs(jget(arch), jshape, jmesh)
    tspecs = tsh.param_specs(cfg, tshape, tmesh)
    layers = {"layers": "decoder", "enc_layers": "encoder"}
    _held(cfg, jspecs, jshape, tspecs, tshape, layers)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_zero1_specs_equal_the_reference(arch, mesh, trees):
    """The reference augments its *stacked* specs, so where the repeats axis
    divides the data size it takes ``"data"`` itself: each data rank holds
    whole layers' moments.  The port's layers are separate tensors, and
    DTensor cannot shard a list of them, so there the port augments the
    layer's own dims, as the reference's ``_augment`` does an unstacked leaf
    (ROADMAP queue C).  Everywhere else the specs are equal."""
    jmesh, tmesh = _meshes(mesh)
    jshape, tshape = trees[arch]
    cfg = tget(arch)
    dsize = axis_size(tmesh, "data")
    jspecs = jsh.param_specs(jget(arch), jshape, jmesh)
    jz, jsp, jshp = (_jflat(t) for t in (jzero1(jspecs, jshape, data_size=dsize), jspecs, jshape))
    tz = zero1_specs(tsh.param_specs(cfg, tshape, tmesh), tshape, data_size=dsize)
    by_layer = 0
    for path, spec in _port_by_ref_path(cfg, tz, {"layers": "decoder", "enc_layers": "encoder"}):
        want = _parts(jz[path])
        if "/body/" in f"/{path}/":
            if want[0] == "data":
                by_layer += 1
                inner = jax.sharding.PartitionSpec(*_parts(jsp[path])[1:])
                want = _parts(jaugment(inner, tuple(jshp[path].shape[1:]), "data", dsize))
            else:
                assert want[0] is None, (path, want)
                want = want[1:]
        assert _parts(spec) == want, (path, spec, want)
    repeats = [cfg.repeats] + ([cfg.n_enc_layers] if cfg.is_encoder_decoder else [])
    assert (by_layer > 0) == any(r % dsize == 0 and r >= dsize for r in repeats)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    for shape in SHAPES.values():
        jb = input_specs(jget(arch), shape)
        tb = {k: torch.empty(tuple(v.shape), device="meta") for k, v in jb.items()}
        jspecs = jsh.batch_specs(jget(arch), jb, jmesh)
        tspecs = tsh.batch_specs(tget(arch), tb, tmesh)
        assert {k: _parts(v) for k, v in tspecs.items()} == {k: _parts(v) for k, v in jspecs.items()}, shape


@pytest.mark.parametrize("optimized", [True, False], ids=["optimized", "baseline"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch, mesh, optimized):
    """At a batched decode (128 × 1024) and at batch 1 (long context, where
    the cache's sequence shards instead)."""
    jmesh, tmesh = _meshes(mesh)
    jm, cfg = JModel(jget(arch)), tget(arch)
    for batch, max_len in ((128, 1024), (1, 4096)):
        jshape = jax.eval_shape(lambda: jm.init_cache(batch, max_len))
        tshape = Model(cfg, "meta").init_cache(batch, max_len)
        jspecs = jsh.cache_specs(jget(arch), jshape, jmesh, optimized=optimized)
        tspecs = tsh.cache_specs(cfg, tshape, tmesh, optimized=optimized)
        _held(cfg, jspecs, jshape, tspecs, tshape, {"layers": "decoder"})


def test_spec_functions_read_a_mesh_through_axis_size_and_data_axes():
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(m) == ("pod", "data")
    assert axis_size(m, ("pod", "data")) == 32 and axis_size(m, "model") == 16
    assert tsh.P(None, ("pod", "data")) == (None, ("pod", "data"))
    assert tuple(tsh.P("model", None)) == ("model", None)
    # a spec is a leaf of the port's trees, not a tuple to walk into
    assert tree_map(lambda s: len(s), {"a": tsh.P(None, "model")}) == {"a": 2}


def test_llama_attention_and_moe_specs_as_the_reference_states_them():
    """The reference's spot checks (``tests/test_sharding.py``), on the port's
    unstacked layers: column-parallel QKV and gate/up, row-parallel O and
    down, replicated norms, expert-parallel MoE with a replicated router."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for arch in ("llama3.2-3b", "deepseek-moe-16b"):
        cfg = tget(arch)
        jshape = jax.eval_shape(JModel(jget(arch)).init, jax.random.key(0))
        layers = tsh.param_specs(cfg, params_from_jax(_meta(jshape), cfg, "meta"), mesh)["layers"]
        body = layers[len(cfg.prefix_pattern)]
        if arch == "llama3.2-3b":
            assert body["mixer"]["q"]["w"] == tsh.P(None, "model")
            assert body["mixer"]["o"]["w"] == tsh.P("model", None)
            assert body["ffn"]["gate"]["w"] == tsh.P(None, "model")
            assert body["ffn"]["down"]["w"] == tsh.P("model", None)
            assert body["norm1"]["w"] == tsh.P(None)
        else:
            assert body["ffn"]["gate"] == tsh.P("model", None, None)
            assert body["ffn"]["router"]["w"] == tsh.P(None, None)


@pytest.fixture
def fake_world():
    """A process group of 512 fake ranks in this process (no collectives
    run), destroyed afterwards."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512, timeout=timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_to_shardings_places_as_jax_names_them(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(ValueError, match="needs a process group of 256"):
        make_mesh((16, 16), ("data", "model"), device_type="cpu")
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), device_type="cpu")
    assert axis_size(mesh, ("pod", "data")) == 32 and data_axes(mesh) == ("pod", "data")
    specs = {
        "col": tsh.P(None, "model"),
        "row": tsh.P("model", None),
        "batch": tsh.P(("pod", "data"), None),
        "both": tsh.P(("pod", "data"), "model"),
        "rep": tsh.P(None, None),
        "scalar": tsh.P(),
    }
    got = {k: s.placements for k, s in tsh.to_shardings(mesh, specs).items()}
    R = Replicate()
    assert got == {
        "col": (R, R, Shard(1)),
        "row": (R, R, Shard(0)),
        "batch": (Shard(0), Shard(0), R),
        "both": (Shard(0), Shard(0), Shard(1)),
        "rep": (R, R, R),
        "scalar": (R, R, R),
    }
    with pytest.raises(ValueError, match="mesh's axis order"):
        tsh.NamedSharding(mesh, tsh.P(("data", "pod"))).placements


def test_distribute_params_places_each_leaf_by_its_spec(fake_world):
    """On the fake 512-rank mesh each local shard has the spec's size (the
    fake group moves no data, so the values are held on gloo meshes in
    ``tests/test_torch_hints.py``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ModelConfig

    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), device_type="cpu")
    cfg = ModelConfig(name="tiny", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                      dtype="float32", remat=False)
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    placed = tsh.distribute_params(params, tsh.param_specs(cfg, params, mesh), mesh)
    q = placed["layers"][0]["mixer"]["q"]["w"]
    assert tuple(q.shape) == (64, 64) and tuple(q.to_local().shape) == (64, 4)
    assert tuple(placed["embed"].to_local().shape) == (16, 64)
    assert tuple(placed["final_norm"]["w"].to_local().shape) == (64,)
