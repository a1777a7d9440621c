"""The port's AdamW and int8 compression against ``repro.optim``.

Inputs are made with numpy and handed to both packages.  AdamW is compared
step by step at rtol 1e-6 in fp32, through warmup and cosine decay: the two
compute the same fp32 operations, but the global norm sums in another order,
so the clip scale may differ by an ulp; where a moment is a difference of
nearly equal values, the 1e-6 is taken of the leaf's largest value.  Compression, decompression and the mean are compared bit for
bit: each is one elementwise fp32 operation after another, with the same
rounding (half to even) on both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import _bridge
from repro_torch.optim import adamw as tadamw

# the packages re-export the function ``compress`` under the module's name
jcompress = importlib.import_module("repro.optim.compress")
tcompress = importlib.import_module("repro_torch.optim.compress")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": a(6, 5), "b": a(5), "layers": [{"k": a(3, 4, 2)}, {"k": a(3, 4, 2)}]}


def to_t(tree):
    return _bridge.tree_map(lambda a: _bridge.to_torch(a), tree)


def to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_tree(got, want, **tol):
    g = _bridge.tree_flatten_with_path(got)
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in g] == ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in w]
    for (name, a), (_, b) in zip(g, w):
        a = _bridge.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        if tol:
            # rtol of each value, or of the leaf's largest where values cancel
            atol = tol["rtol"] * float(np.max(np.abs(b)))
            np.testing.assert_allclose(a, b, rtol=tol["rtol"], atol=atol, err_msg=name)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference_step_by_step(clip):
    # warmup 3 of 8 total steps: steps 1-2 warm, 3 the boundary, 4-8 cosine
    jcfg = jadamw.AdamWConfig(warmup_steps=3, total_steps=8, clip_norm=clip)
    tcfg = tadamw.AdamWConfig(warmup_steps=3, total_steps=8, clip_norm=clip)
    p0 = np_tree(0)
    jp, tp = to_j(p0), to_t(p0)
    js, ts = jadamw.init(jp), tadamw.init(tp)
    jup = jax.jit(lambda g, s, p: jadamw.update(jcfg, g, s, p))
    for step in range(10):
        g = np_tree(100 + step, scale=0.5)
        jp, js, jm = jup(to_j(g), js, jp)
        tg = to_t(g)
        before = [t.clone() for t in _bridge.tree_leaves((tp, ts, tg))]
        tp_new, ts_new, tm = tadamw.update(tcfg, tg, ts, tp)
        # functional: the arguments are left as they were, the fp32 grads too
        # (the pods' updates share one tree of mean grads)
        assert all(torch.equal(a, b) for a, b in zip(before, _bridge.tree_leaves((tp, ts, tg))))
        tp, ts = tp_new, ts_new
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
        assert_tree(tp, jp, rtol=1e-6)
        assert_tree(ts.m, js.m, rtol=1e-6)
        assert_tree(ts.v, js.v, rtol=1e-6)


def test_adamw_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    s = tadamw.init(p)
    assert s.m["w"].dtype == torch.float32 and s.step.dtype == torch.int32
    new_p, new_s, _ = tadamw.update(tadamw.AdamWConfig(), {"w": torch.ones_like(p["w"])}, s, p)
    assert new_p["w"].dtype == torch.bfloat16 and new_s.v["w"].dtype == torch.float32
    assert type(new_s) is tadamw.AdamWState


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 8, 12])
def test_schedule_matches_reference(step):
    jcfg = jadamw.AdamWConfig(warmup_steps=3, total_steps=8)
    tcfg = tadamw.AdamWConfig(warmup_steps=3, total_steps=8)
    want = np.asarray(jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = tadamw.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_global_norm_matches_reference():
    t = np_tree(3)
    np.testing.assert_allclose(
        float(tadamw.global_norm(to_t(t))), float(jadamw.global_norm(to_j(t))), rtol=1e-6
    )


def _with_edges(tree):
    """Rows of zeros, -0.0, exact .5 multiples of the scale and huge values."""
    w = tree["w"]
    w[0] = 0.0
    w[1] = -0.0
    w[2] = np.array([127.0, 63.5, -0.5, 1.5, 2.5], np.float32)
    w[3, 0] = 3e38
    return tree


def test_compress_decompress_bit_for_bit_with_error_feedback():
    g0, g1 = _with_edges(np_tree(7)), np_tree(8, scale=1e-3)
    jc, je = jcompress.compress(to_j(g0))
    tc, te = tcompress.compress(to_t(g0))
    assert type(tc) is tcompress.Compressed
    assert_tree(tc.q, jc.q)
    assert_tree(tc.scale, jc.scale)
    assert_tree(te, je)
    # the second step folds the first step's residual in
    jc2, je2 = jcompress.compress(to_j(g1), je)
    tc2, te2 = tcompress.compress(to_t(g1), te)
    assert_tree(tc2.q, jc2.q)
    assert_tree(tc2.scale, jc2.scale)
    assert_tree(te2, je2)
    assert_tree(tcompress.decompress(tc2), jcompress.decompress(jc2))
    assert tcompress.compressed_bytes(tc2) == jcompress.compressed_bytes(jc2)


def test_compress_takes_bf16_grads_and_allreduce_mean_bit_for_bit():
    parts = [np_tree(20 + i) for i in range(3)]
    assert_tree(
        tcompress.allreduce_mean([to_t(p) for p in parts]),
        jcompress.allreduce_mean([to_j(p) for p in parts]),
    )
    g = _bridge.tree_map(lambda a: a.astype(jnp.bfloat16), np_tree(30))
    jc, je = jcompress.compress(jax.tree.map(jnp.asarray, g))
    tc, te = tcompress.compress(_bridge.tree_map(_bridge.to_torch, g))
    assert_tree(tc.q, jc.q)
    assert_tree(tc.scale, jc.scale)
    assert_tree(te, je)
