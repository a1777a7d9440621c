"""The port's layers (plain path, CPU) against ``repro.models.layers``.

Both sides get the same numpy inputs and weights.  Tolerances: fp32 2e-5 on
single layers (the frameworks sum in different orders); bf16 2e-2 (one bf16
ulp is 2^-8 relative, and the two frameworks round intermediates at
different places).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JConfig
from repro.models import layers as jl
from repro_torch.models import ModelConfig as TConfig
from repro_torch.models import layers as tl

BASE = dict(
    name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, dtype="float32", remat=False,
)

# The JAX side jitted: one compile per shape instead of one per op.
j_sdpa = jax.jit(jl.sdpa, static_argnames=("causal", "window", "softcap", "q_chunk", "stride_chunks"))
j_rope = jax.jit(jl.apply_rope, static_argnames=("theta",))


def j_attention_block(cfg, *args, **kw):
    return jax.jit(partial(jl.attention_block, cfg), static_argnames=("causal",))(*args, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tensors here are tiny: torch's CPU thread pool costs more than it
    # saves (over 100x on a shared machine), so run them on one thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want, tol=2e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _cfgs(**kw):
    return JConfig(**{**BASE, **kw}), TConfig(**{**BASE, **kw})


def _linear(seed, d_in, d_out, bias=False):
    p = {"w": _normal(seed, d_in, d_out, scale=d_in**-0.5)}
    if bias:
        p["b"] = _normal(seed + 1, d_out, scale=0.1)
    return p


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, w = _normal(0, 3, 5, 64), _normal(1, 64, scale=0.1)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jl.rms_norm(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))
    got = tl.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)


def test_layer_norm():
    x, w, b = _normal(2, 4, 64), _normal(3, 64), _normal(4, 64)
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(tl.layer_norm(*(torch.from_numpy(a) for a in (x, w, b))), want)


@pytest.mark.parametrize("pos_shape", ["L", "BL"])
def test_apply_rope(pos_shape):
    x = _normal(5, 2, 7, 3, 16)
    pos = np.arange(3, 10, dtype=np.int32)
    if pos_shape == "BL":
        pos = np.stack([pos, pos + 100])
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    # positions up to ~100 rad: sin/cos of fp32 angles differ in the last
    # place between the two libraries.
    _close(got, want, 1e-4)


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "relu_sq", "gelu"])
def test_apply_mlp(act):
    jc, tc = _cfgs(activation=act)
    p = {"up": _linear(10, 64, 128), "down": _linear(11, 128, 64)}
    if act.endswith("_glu"):
        p["gate"] = _linear(12, 64, 128)
    x = _normal(13, 2, 5, 64)
    want = jl.apply_mlp(jc, _j(p), jnp.asarray(x))
    _close(tl.apply_mlp(tc, _t(p), torch.from_numpy(x)), want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(causal=True),
        dict(causal=False),
        dict(causal=True, window=5),
        dict(causal=True, softcap=30.0),
        dict(causal=True, q_chunk=8),
        dict(causal=True, q_chunk=8, stride_chunks=True),
        dict(causal=True, q_offset=9, kv_valid=33, q_chunk=8, stride_chunks=True),
        dict(causal=True, q_offset=9, kv_valid=33),
    ],
    ids=["causal", "bidir", "window", "softcap", "chunked", "strided", "offset_strided", "offset"],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa(kw, dtype):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    q = _normal(20, 2, 24, 4, 16)
    k = _normal(21, 2, 40, 2, 16)
    v = _normal(22, 2, 40, 2, 16)
    if "q_offset" not in kw:
        k, v = k[:, :24], v[:, :24]
    want = j_sdpa(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), **kw)
    tkw = {**kw}
    if "q_offset" in kw:  # the port takes device int32 scalars, as the model passes them
        tkw["q_offset"] = torch.tensor(kw["q_offset"], dtype=torch.int32)
        tkw["kv_valid"] = torch.tensor(kw["kv_valid"], dtype=torch.int32)
    got = tl.sdpa(*(torch.from_numpy(np.ascontiguousarray(a)).to(td) for a in (q, k, v)), **tkw)
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)


def _attn_params(cfg, bias):
    return {
        "q": _linear(30, cfg.d_model, cfg.q_dim, bias),
        "k": _linear(32, cfg.d_model, cfg.kv_dim, bias),
        "v": _linear(34, cfg.d_model, cfg.kv_dim, bias),
        "o": _linear(36, cfg.q_dim, cfg.d_model),
    }


@pytest.mark.parametrize("bias", [False, True])
def test_attention_block_with_cache(bias):
    jc, tc = _cfgs(qkv_bias=bias)
    p = _attn_params(jc, bias)
    b, m = 2, 16
    jcache = jl.init_kv_cache(jc, b, m, jnp.float32)
    tcache = tl.init_kv_cache(tc, b, m, torch.float32, "cpu")
    for step, l in enumerate((5, 1, 1, 3)):  # prefill, two decodes, a second prefill
        x = _normal(40 + step, b, l, 64)
        start = int(jcache["len"])
        pos = np.arange(start, start + l, dtype=np.int32)
        jout, jcache = j_attention_block(
            jc, _j(p), jnp.asarray(x), positions=jnp.asarray(pos), causal=True, cache=jcache
        )
        prev_k = tcache["k"]
        tout, tcache = tl.attention_block(
            tc, _t(p), torch.from_numpy(x), positions=torch.from_numpy(pos), causal=True,
            cache=tcache,
        )
        assert tcache["k"] is prev_k  # written in place
        assert int(tcache["len"]) == int(jcache["len"]) == start + l
        _close(tout, jout)
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])


def test_attention_block_cache_free_matches_reference():
    jc, tc = _cfgs()
    p = _attn_params(jc, False)
    x = _normal(50, 2, 9, 64)
    pos = np.arange(9, dtype=np.int32)
    jout, _ = j_attention_block(jc, _j(p), jnp.asarray(x), positions=jnp.asarray(pos), causal=True)
    tout, cache = tl.attention_block(
        tc, _t(p), torch.from_numpy(x), positions=torch.from_numpy(pos), causal=True
    )
    assert cache is None
    _close(tout, jout)


def test_init_kv_cache_matches_reference():
    jc, tc = _cfgs()
    jcache = jl.init_kv_cache(jc, 3, 11, jnp.bfloat16)
    tcache = tl.init_kv_cache(tc, 3, 11, torch.bfloat16, "cpu")
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        assert tcache[key].dtype == torch.bfloat16
    assert tcache["len"].dtype == torch.int32 and tcache["len"].ndim == 0


def test_set_attn_impl_validates():
    with pytest.raises(ValueError):
        tl.set_attn_impl("pallas")
    assert tl.get_attn_impl() is None


def test_config_copy_matches_reference():
    # The port's own copy of ModelConfig derives the same values.
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    for smoke in (False, True):
        j, t = jget("llama3.2-3b", smoke=smoke), tget("llama3.2-3b", smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.repeats, j.q_dim, j.kv_dim, j.layer_seq()) == (t.repeats, t.q_dim, t.kv_dim, t.layer_seq())
    with pytest.raises(KeyError, match="llama3.2-3b"):
        tget("xlstm-125m")
