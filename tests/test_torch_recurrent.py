"""The port's recurrent mixers (``repro_torch.models.recurrent``) against
``repro.models.recurrent``.

Weights are the reference's own ``init_mamba`` / ``init_mlstm`` /
``init_slstm``, carried across bit for bit (bf16 as ``uint16`` bits); inputs
are made with numpy from a seed; a carried state is the reference's own,
carried across the same way.  Tolerances are ``TOL`` of
``tests/test_kernels.py``, atol and rtol: fp32 2e-5 (the port's Hillis–Steele
scan and the reference's ``associative_scan`` associate the same terms in
different trees, and the einsums sum in other orders), bf16 2e-2 (a bf16
output can round to its neighbour).  Gradients: atol 1e-5 + rtol 1e-4 on
each leaf, as ``tests/test_torch_train.py`` holds a model's (the backward
sums in other orders again).

The eight tests of ``tests/test_recurrent.py`` follow, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro.models.config import ModelConfig as JConfig
from repro.models.config import SSMCfg as JSSM
from repro_torch._bridge import to_torch, tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.models import recurrent as trec
from repro_torch.models.config import ModelConfig, SSMCfg
from repro_torch.models.recurrent import (
    MLSTMState,
    init_mamba,
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    mamba_mix,
    mlstm_mix,
    slstm_mix,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MIXERS = ("mamba", "mlstm", "slstm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(chunk, d=32, heads=2, ds=4, dtype="float32"):
    kw = dict(name="t", n_layers=2, d_model=d, n_heads=heads, n_kv_heads=heads,
              head_dim=d // heads, d_ff=0, vocab=64, dtype=dtype, remat=False)
    ssm = dict(d_state=ds, d_conv=4, expand=2, chunk=chunk)
    return JConfig(**kw, ssm=JSSM(**ssm)), ModelConfig(**kw, ssm=SSMCfg(**ssm))


def _host(tree):
    return jax.tree.map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a), tree
    )


def _to_port(tree):
    """A reference tree (params or a state NamedTuple) as torch tensors, bit for bit."""
    return tree_map(to_torch, _host(tree))


def _params(mixer, jcfg, seed=0):
    jp = getattr(jrec, f"init_{mixer}")(jax.random.key(seed), jcfg, jnp.dtype(jcfg.dtype))
    return jp, _to_port(jp)


def _x(seed, shape, dtype, scale=0.5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol, err_msg=what)


def _close_state(got, want, tol):
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for field, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype), field
        _close(a, b, tol, field)


# ---------------------------------------------------------------------------
# Each mixer against the reference's: outputs and every state field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 5, 16])  # 5 does not divide L = 12; 16 > L
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_and_its_state_match_the_reference(mixer, dtype, chunk):
    jcfg, tcfg = _cfgs(chunk, dtype=dtype)
    jp, tp = _params(mixer, jcfg)
    jmix, tmix = jax.jit(getattr(jrec, f"{mixer}_mix"), static_argnums=0), getattr(trec, f"{mixer}_mix")
    tol = TOL[dtype]
    jx, tx = _x(1, (2, 12, jcfg.d_model), dtype)

    jy, jst = jmix(jcfg, jp, jx)  # from no state
    ty, tst = tmix(tcfg, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, tol, "y")
    _close_state(tst, jst, tol)

    # From the reference's carried state, carried across bit for bit.
    jx2, tx2 = _x(2, (2, 7, jcfg.d_model), dtype)
    jy2, jst2 = jmix(jcfg, jp, jx2, jst)
    ty2, tst2 = tmix(tcfg, tp, tx2, _to_port(jst))
    _close(ty2, jy2, tol, "y from a carried state")
    _close_state(tst2, jst2, tol)


@pytest.mark.parametrize("mixer", MIXERS)
def test_one_token_steps_match_the_reference(mixer):
    # Decode: L = 1 a call, the state carried from call to call on each side.
    jcfg, tcfg = _cfgs(16, dtype="bfloat16")
    jp, tp = _params(mixer, jcfg)
    jmix, tmix = getattr(jrec, f"{mixer}_mix"), getattr(trec, f"{mixer}_mix")
    jx, tx = _x(3, (2, 6, jcfg.d_model), "bfloat16")
    jst = tst = None
    for t in range(6):
        jy, jst = jmix(jcfg, jp, jx[:, t : t + 1], jst)
        ty, tst = tmix(tcfg, tp, tx[:, t : t + 1], tst)
        _close(ty, jy, TOL["bfloat16"], f"step {t}")
    _close_state(tst, jst, TOL["bfloat16"])


@pytest.mark.parametrize("c", [1, 2, 7, 16, 64])
def test_ssm_chunk_scan_alone_matches_associative_scan(c):
    rng = np.random.default_rng(c)
    # Decays down to -5 a step: over 64 steps the cumulative decay reaches
    # -320, where a closed form's exp(-A) would overflow fp32.
    a = -rng.uniform(0.0, 5.0, (2, c, 3, 4)).astype(np.float32)
    bu = rng.standard_normal((2, c, 3, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    jh, jlast = jrec._ssm_chunk_scan(jnp.asarray(a), jnp.asarray(bu), jnp.asarray(h0))
    th, tlast = trec._ssm_chunk_scan(torch.from_numpy(a), torch.from_numpy(bu), torch.from_numpy(h0))
    assert bool(th.isfinite().all())
    _close(th, jh, TOL["float32"], "h")
    _close(tlast, jlast, TOL["float32"], "last h")


@pytest.mark.parametrize("c", [1, 5, 16])
def test_mlstm_chunk_alone_matches_the_reference(c):
    rng = np.random.default_rng(10 + c)
    b, h, dh = 2, 3, 8

    def r(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    q, k, v = r(b, c, h, dh, scale=dh ** -0.5), r(b, c, h, dh), r(b, c, h, dh)
    li = r(b, c, h)
    lf = np.log(1.0 / (1.0 + np.exp(-r(b, c, h, scale=3.0)))).astype(np.float32)  # log-sigmoid
    st = (r(b, h, dh, dh), r(b, h, dh), r(b, h))
    jy, jst = jrec._mlstm_chunk(*map(jnp.asarray, (q, k, v, li, lf)), jrec.MLSTMState(*map(jnp.asarray, st)))
    ty, tst = trec._mlstm_chunk(*map(torch.from_numpy, (q, k, v, li, lf)),
                                trec.MLSTMState(*map(torch.from_numpy, st)))
    _close(ty, jy, TOL["float32"], "y")
    _close_state(tst, jst, TOL["float32"])


def test_softplus_is_logaddexp_as_jax():
    # F.softplus switches to x above its threshold (20); jax.nn.softplus is
    # logaddexp(x, 0) everywhere.  The port follows the reference.
    x = np.concatenate([np.linspace(-100, 100, 2001), [19.9, 20.0, 20.1, 88.0, 89.0, 1e4]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = trec._softplus(torch.from_numpy(x)).numpy()
    # atol: below x ≈ -87 the result is subnormal, which XLA flushes to 0.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=np.finfo(np.float32).tiny)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# Init: the reference's layout, dtypes and deterministic leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_init_layout_dtypes_and_fixed_leaves_equal_the_reference(mixer, dtype):
    jcfg, tcfg = _cfgs(16, d=64, heads=4, ds=16, dtype=dtype)
    jp, tp_ref = _params(mixer, jcfg)
    mine = getattr(trec, f"init_{mixer}")(torch.Generator().manual_seed(0), tcfg, getattr(torch, dtype))
    got, want = tree_flatten_with_path(mine), tree_flatten_with_path(tp_ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    leaves = dict(got)
    ref = dict(want)
    if mixer == "mamba":
        for name in ("D", "conv_b"):  # drawn from no RNG: equal
            assert torch.equal(leaves[name], ref[name]), name
        # A_log = log(1..d_state), drawn from no RNG either: equal to within
        # one fp32 ulp, because XLA's log rounds log(7) one ulp above the
        # correctly rounded value, which torch's log gives.
        np.testing.assert_allclose(leaves["A_log"].numpy(), ref["A_log"].numpy(), rtol=2.0**-23, atol=0)
        assert (leaves["A_log"] != ref["A_log"]).float().mean() <= 1 / 16
        for name in ("A_log", "D", "dt_proj/b"):
            assert leaves[name].dtype == torch.float32, name
        # softplus(dt bias) lies in [1e-3, 1e-1], as the reference draws it
        dt = trec._softplus(leaves["dt_proj/b"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
        assert float(leaves["dt_proj/b"].min()) >= float(ref["dt_proj/b"].min()) - 1e-2
    elif mixer == "mlstm":
        for g in ("i_gate/w", "f_gate/w"):
            assert leaves[g].dtype == torch.float32, g
    else:
        for g in ("g_i", "g_f", "g_z", "g_o"):
            assert leaves[f"{g}/b"].dtype == torch.float32 and not leaves[f"{g}/b"].any()


# ---------------------------------------------------------------------------
# Gradients against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mixer", MIXERS)
def test_grads_match_jax_grad(mixer, carried):
    jcfg, tcfg = _cfgs(5, d=16, heads=2, ds=3)
    jp, tp = _params(mixer, jcfg)
    jmix, tmix = getattr(jrec, f"{mixer}_mix"), getattr(trec, f"{mixer}_mix")
    jx, tx = _x(4, (2, 9, jcfg.d_model), "float32")
    jst = jmix(jcfg, jp, _x(5, (2, 4, jcfg.d_model), "float32")[0])[1] if carried else None
    dy = np.random.default_rng(6).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, st = jmix(jcfg, p, x, jst)
        # the state enters too, so its gradient path is held as well
        tail = sum(jnp.sum(jnp.tanh(s)) for s in jax.tree.leaves(st) if s.dtype == jnp.float32)
        return jnp.sum(y * dy) + tail

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)

    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    txg = tx.clone().requires_grad_()
    y, st = tmix(tcfg, tp, txg, None if jst is None else _to_port(jst))
    tail = sum(torch.sum(torch.tanh(s)) for s in st if s.dtype == torch.float32)
    loss = torch.sum(y * torch.from_numpy(dy)) + tail
    grads = torch.autograd.grad(loss, leaves + [txg], allow_unused=True)
    names = [n for n, _ in tree_flatten_with_path(tp)]
    jflat = dict(tree_flatten_with_path(_host(jgp)))
    for name, g in zip(names, grads[:-1]):
        want = jflat[name]
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-4, err_msg="x")


# ---------------------------------------------------------------------------
# tests/test_recurrent.py, on the port: chunked parallel forms ≡ sequential
# ---------------------------------------------------------------------------


def _port_cfg(chunk, d=32, heads=2, ds=4):
    return _cfgs(chunk, d=d, heads=heads, ds=ds)[1]


def _px(seed, shape, scale=0.5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale)


def _gen():
    return torch.Generator().manual_seed(0)


class TestMamba:
    @pytest.mark.parametrize("chunk", [1, 3, 8, 64])
    def test_chunking_invariance(self, chunk):
        """Any chunk size gives identical outputs (carried state is exact)."""
        cfg_ref = _port_cfg(chunk=64)
        cfg = _port_cfg(chunk=chunk)
        p = init_mamba(_gen(), cfg_ref, torch.float32)
        x = _px(1, (2, 16, cfg_ref.d_model))
        y_ref, st_ref = mamba_mix(cfg_ref, p, x)
        y, st = mamba_mix(cfg, p, x)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-4)
        np.testing.assert_allclose(st.ssm.numpy(), st_ref.ssm.numpy(), atol=1e-4)

    def test_streaming_equals_batch(self):
        """Feeding the sequence in two halves through the carried state
        equals one full pass (the decode-path invariant)."""
        cfg = _port_cfg(chunk=4)
        p = init_mamba(_gen(), cfg, torch.float32)
        x = _px(1, (2, 16, cfg.d_model))
        y_full, _ = mamba_mix(cfg, p, x)
        y1, st = mamba_mix(cfg, p, x[:, :9])
        y2, _ = mamba_mix(cfg, p, x[:, 9:], st)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=1e-4)

    def test_reference_scan(self):
        """Chunked scan ≡ naive per-step recurrence."""
        cfg = _port_cfg(chunk=16, d=16, heads=2, ds=3)
        p = init_mamba(_gen(), cfg, torch.float32)
        x = _px(1, (1, 8, cfg.d_model))
        y, _ = mamba_mix(cfg, p, x)
        cfg1 = _port_cfg(chunk=1, d=16, heads=2, ds=3)
        st, outs = None, []
        for t in range(8):
            yt, st = mamba_mix(cfg1, p, x[:, t : t + 1], st)
            outs.append(yt)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y.numpy(), atol=1e-4)


class TestMLSTM:
    @pytest.mark.parametrize("chunk", [1, 2, 5, 16])
    def test_chunking_invariance(self, chunk):
        cfg_ref = _port_cfg(chunk=16)
        cfg = _port_cfg(chunk=chunk)
        p = init_mlstm(_gen(), cfg_ref, torch.float32)
        x = _px(1, (2, 16, cfg_ref.d_model))
        y_ref, _ = mlstm_mix(cfg_ref, p, x)
        y, _ = mlstm_mix(cfg, p, x)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=2e-4)

    def test_streaming_equals_batch(self):
        cfg = _port_cfg(chunk=4)
        p = init_mlstm(_gen(), cfg, torch.float32)
        x = _px(1, (2, 12, cfg.d_model))
        y_full, _ = mlstm_mix(cfg, p, x)
        y1, st = mlstm_mix(cfg, p, x[:, :7])
        y2, _ = mlstm_mix(cfg, p, x[:, 7:], st)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=2e-4)

    def test_forget_gate_decays_carry(self):
        """With strongly negative forget logits the memory resets; outputs
        must stay finite (stabiliser working)."""
        cfg = _port_cfg(chunk=4)
        p = dict(init_mlstm(_gen(), cfg, torch.float32))
        p["f_gate"] = {"w": p["f_gate"]["w"], "b": torch.full((cfg.n_heads,), -30.0)}
        x = _px(1, (1, 8, cfg.d_model), scale=1.0)
        y, st = mlstm_mix(cfg, p, x)
        assert bool(torch.isfinite(y).all())
        assert bool(torch.isfinite(st.c).all())
        assert isinstance(init_mlstm_state(cfg, 1, "cpu"), MLSTMState)


class TestSLSTM:
    def test_streaming_equals_batch(self):
        cfg = _port_cfg(chunk=4, d=16)
        p = init_slstm(_gen(), cfg, torch.float32)
        x = _px(1, (2, 10, cfg.d_model))
        y_full, _ = slstm_mix(cfg, p, x)
        y1, st = slstm_mix(cfg, p, x[:, :6])
        y2, _ = slstm_mix(cfg, p, x[:, 6:], st)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=1e-5)

    def test_stability_long_run(self):
        cfg = _port_cfg(chunk=4, d=16)
        p = init_slstm(_gen(), cfg, torch.float32)
        x = _px(1, (1, 200, cfg.d_model), scale=2.0)
        y, st = slstm_mix(cfg, p, x)
        assert bool(torch.isfinite(y).all())
        assert bool(torch.isfinite(st.m).all())
