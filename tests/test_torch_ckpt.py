"""The port's data pipeline and checkpoints against the JAX package's.

``SyntheticLM`` is a numpy copy: batches must be equal bit for bit.
Checkpoints must cross frameworks both ways bit for bit: a bf16 tree written
by ``repro.ckpt`` reads back into the port, and a tree the port writes reads
back into ``repro.ckpt`` with the same leaf names, files, shapes and dtypes,
for every family (dense, MoE, recurrent, and gemma2's post norms, seamless's
encoder and cross-attention, internvl2's ``vision_proj``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_config as jget
from repro.data import ShardedLoader as JLoader
from repro.data import SyntheticLM as JSynth
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch import _bridge
from repro_torch import ckpt as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.data import ShardedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynth
from repro_torch.launch.train import checkpoint_tree
from repro_torch.models import Model as TModel
from repro_torch.models import params_from_jax, params_to_jax
from repro_torch.optim import adamw as tadamw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,seq_len,global_batch,seed", [(512, 32, 4, 0), (128256, 17, 6, 3)])
def test_synthetic_lm_batches_are_equal(vocab, seq_len, global_batch, seed):
    j = JSynth(vocab=vocab, seq_len=seq_len, global_batch=global_batch, seed=seed)
    t = TSynth(vocab=vocab, seq_len=seq_len, global_batch=global_batch, seed=seed)
    for step in (0, 1, 7, 10**6):
        for n_shards in (1, 2) if global_batch % 2 == 0 else (1,):
            for shard in range(n_shards):
                a, b = j.batch(step, shard, n_shards), t.batch(step, shard, n_shards)
                assert sorted(a) == sorted(b) == ["labels", "tokens"]
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.int32
                    assert a[k].tobytes() == b[k].tobytes(), (step, shard, k)


def test_sharded_loader_yields_the_same_steps():
    ds = dict(vocab=512, seq_len=8, global_batch=4)
    jl = JLoader(JSynth(**ds), shard=1, n_shards=2, start_step=5)
    tl = TLoader(TSynth(**ds), shard=1, n_shards=2, start_step=5)
    try:
        for _ in range(3):
            (js, jb), (ts, tb) = next(jl), next(tl)
            assert js == ts
            assert jb["tokens"].tobytes() == tb["tokens"].tobytes()
    finally:
        jl.close()
        tl.close()


# name: (arch, changes to its smoke config).  The MoE trees hold the fp32
# router beside bf16 experts ([R, E, ...] stacked in the reference) and,
# for deepseek, the shared experts and a dense0 prefix layer.
VARIANTS = {
    "fp32": ("llama3.2-3b", {}),
    "bf16-gqa": ("llama3.2-3b", {"dtype": "bfloat16", "n_heads": 4, "n_kv_heads": 2, "n_layers": 3}),
    "granite-moe-bf16": ("granite-moe-1b-a400m", {"dtype": "bfloat16", "n_layers": 3}),
    "deepseek-moe-bf16": ("deepseek-moe-16b", {"dtype": "bfloat16", "n_layers": 3}),
    # The recurrent trees: mamba's conv, x_proj, dt_proj and its fp32 A_log,
    # D and dt bias; the mLSTM's fp32 gates; the sLSTM's g_* with fp32 biases.
    "xlstm-bf16": ("xlstm-125m", {"dtype": "bfloat16", "n_layers": 4}),
    "jamba-bf16": ("jamba-v0.1-52b", {"dtype": "bfloat16"}),
    # The other families' trees: gemma2's post norms (a local and a global
    # layer), seamless's encoder stack, enc_norm and each decoder block's
    # norm_cross and cross (LayerNorm: w and b), internvl2's vision_proj
    # beside its QKV biases.
    "gemma2-bf16": ("gemma2-27b", {"dtype": "bfloat16"}),
    "seamless-bf16": ("seamless-m4t-medium", {"dtype": "bfloat16", "n_layers": 2}),
    "internvl2-bf16": ("internvl2-1b", {"dtype": "bfloat16", "n_layers": 2}),
}
# Leaves of the other families, by the reference's names.
FAMILY_LEAVES = {
    "gemma2-bf16": {"decoder/body/0/post_norm1/w", "decoder/body/1/post_norm2/w", "decoder/body/1/mixer/q/w"},
    "seamless-bf16": {"encoder/body/0/mixer/q/w", "encoder/body/0/norm2/b", "enc_norm/w", "enc_norm/b",
                      "decoder/body/0/norm_cross/b", "decoder/body/0/cross/k/w", "decoder/body/0/cross/o/w"},
    "internvl2-bf16": {"vision_proj/w", "decoder/body/0/mixer/q/b"},
}
# The leaves that stay fp32 in a bf16 tree (as the reference inits them).
FP32_LEAVES = ("router/w", "A_log", "/D", "dt_proj/b", "i_gate/w", "f_gate/w",
               "g_i/b", "g_f/b", "g_z/b", "g_o/b")


def setup(variant):
    arch, kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tget(arch, smoke=True), **kw)
    jp = JModel(jcfg).init(jax.random.key(0))
    return jcfg, tcfg, jp


def host(tree):
    return jax.tree.map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a), tree
    )


def jax_state(jp, seed=1):
    """A reference AdamW state with nonzero moments, from one update."""
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jp)
    _, st, _ = jadamw.update(jadamw.AdamWConfig(), grads, jadamw.init(jp), jp)
    return st


def assert_files_equal(a_dir, b_dir):
    ma = json.loads((a_dir / "manifest.json").read_text())
    mb = json.loads((b_dir / "manifest.json").read_text())
    assert ma == mb
    for e in ma["leaves"]:
        assert np.load(a_dir / e["file"]).tobytes() == np.load(b_dir / e["file"]).tobytes(), e["name"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_to_jax_inverts_params_from_jax(variant):
    jcfg, tcfg, jp = setup(variant)
    tp = params_from_jax(host(jp), tcfg, "cpu")
    back = params_to_jax(tp, tcfg)
    names = [n for n, _ in _bridge.tree_flatten_with_path(back)]
    assert names == ["/".join(str(k.key if hasattr(k, "key") else k.idx) for k in p)
                     for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    if tcfg.moe.n_experts:  # the MoE leaves, by the reference's names
        j = [f for _, f in tcfg.pattern].index("moe")  # jamba's first MoE FFN is at position 1
        assert {f"decoder/body/{j}/ffn/gate", f"decoder/body/{j}/ffn/router/w"} <= set(names)
    if tcfg.pattern[0][0] in ("mamba", "mlstm"):  # the recurrent leaves, by the reference's names
        want = ({"decoder/body/0/mixer/A_log", "decoder/body/0/mixer/dt_proj/b", "decoder/body/0/mixer/conv_w"}
                if "jamba" in variant else
                {"decoder/body/0/mixer/i_gate/w", "decoder/body/1/mixer/g_z/r", "decoder/body/1/mixer/g_o/b"})
        assert want <= set(names), sorted(want - set(names))
    want = FAMILY_LEAVES.get(variant, set())
    assert want <= set(names), sorted(want - set(names))
    for got, want in zip(_bridge.tree_leaves(back), jax.tree.leaves(host(jp))):
        assert _bridge.to_numpy(got).tobytes() == want.tobytes()
    again = params_from_jax(back, tcfg, "cpu")
    for a, b in zip(_bridge.tree_leaves(again), _bridge.tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_checkpoint_from_jax_reads_into_the_port(variant, tmp_path):
    jcfg, tcfg, jp = setup(variant)
    st = jax_state(jp)
    jckpt.save_checkpoint(tmp_path, 7, {"params": jp, "opt": st._asdict()})
    # the port's resume path: a like-tree from its own (differently seeded) init
    tm = TModel(tcfg, "cpu")
    tp0 = tm.init(torch.Generator().manual_seed(5))
    like = checkpoint_tree(tcfg, tp0, tadamw.init(tp0))
    assert tckpt.latest_step(tmp_path) == 7
    got = tckpt.load_checkpoint(tmp_path, 7, like)
    want = host({"params": jp, "opt": st._asdict()})
    gl, wl = _bridge.tree_flatten_with_path(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(gl) == len(wl)
    for (name, a), (_, b) in zip(gl, wl):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    tp = params_from_jax(got["params"], tcfg, "cpu")
    for name, p in _bridge.tree_flatten_with_path(tp):
        assert p.dtype == (torch.float32 if name.endswith(FP32_LEAVES) else getattr(torch, jcfg.dtype)), name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_checkpoint_from_the_port_reads_into_jax_and_matches_its_files(variant, tmp_path):
    jcfg, tcfg, jp = setup(variant)
    st = jax_state(jp)
    tp = params_from_jax(host(jp), tcfg, "cpu")
    tst = tadamw.AdamWState(
        step=_bridge.to_torch(np.asarray(st.step)),
        m=params_from_jax(host(st.m), tcfg, "cpu"),
        v=params_from_jax(host(st.v), tcfg, "cpu"),
    )
    tckpt.async_save(tmp_path / "t", 3, checkpoint_tree(tcfg, tp, tst)).wait()
    jckpt.save_checkpoint(tmp_path / "j", 3, {"params": jp, "opt": st._asdict()})
    assert_files_equal(tmp_path / "t" / "step_000000003", tmp_path / "j" / "step_000000003")
    like = {"params": jp, "opt": st._asdict()}
    back = jckpt.load_checkpoint(tmp_path / "t", 3, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(like)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_latest_step_ignores_interrupted_writes_and_gc_keeps_three(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    for s in (1, 2, 3, 4):
        tckpt.save_checkpoint(tmp_path, s, tree)
    (tmp_path / "step_000000009").mkdir()  # no manifest: an interrupted write
    assert tckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*") if (p / "manifest.json").exists()) == [
        "step_000000002", "step_000000003", "step_000000004"]
    assert jckpt.latest_step(tmp_path) == 4
    assert tckpt.latest_step(tmp_path / "nothing") is None
    back = tckpt.load_checkpoint(tmp_path, 4, tree)
    assert back["b"][0].dtype == np.uint16 and _bridge.to_torch(back["b"][0]).dtype == torch.bfloat16
    m = json.loads((tmp_path / "step_000000004" / "manifest.json").read_text())
    assert [(e["name"], e["dtype"]) for e in m["leaves"]] == [("a", "float32"), ("b/0", "bfloat16")]
    with pytest.raises(KeyError, match="missing"):
        tckpt.load_checkpoint(tmp_path, 4, {"c": tree["a"]})


def test_tree_map_keeps_namedtuples_and_unflatten_checks_counts():
    st = tadamw.AdamWState(step=torch.zeros(()), m={"b": 1, "a": 2}, v=[3])
    out = _bridge.tree_map(lambda x: x, st)
    assert type(out) is tadamw.AdamWState and out.m == {"b": 1, "a": 2}
    assert [n for n, _ in _bridge.tree_flatten_with_path(st)] == ["step", "m/a", "m/b", "v/0"]
    assert _bridge.tree_unflatten(st.m, [10, 20]) == {"b": 20, "a": 10}
    with pytest.raises(ValueError, match="more leaves"):
        _bridge.tree_unflatten(st.m, [1, 2, 3])
    with pytest.raises(ValueError, match="fewer leaves"):
        _bridge.tree_unflatten(st.m, [1])
