"""The other families' pieces (plain path, CPU) against the JAX package.

Each unit gets the same numpy inputs and the reference's weights on both
sides: the cross-attention block, ``final_logit_softcap``, a block with
``post_block_norm`` (and a sliding window and the attention softcap), the
encoder, and the vision prefix's positions.  Tolerances: fp32 2e-5 on a
single layer or head (``TOL`` of ``tests/test_kernels.py``), 1e-4 through
a whole model (as ``tests/test_torch_model.py``); bf16 2e-2 by relative L2.

Then each arch's smoke config on the kernel path, rehearsed on the CPU (the
kernels' wrappers take their plain versions for CPU tensors): a prefill and
a decode step must call each kernel as often as ``chip_smoke.py``'s
``serve_launches`` expects on the card, and give the plain path's logits.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models import layers as jl
from repro.models import model as jmodel
from repro_torch._bridge import to_torch, tree_map
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import rmsnorm as krmsnorm
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel
from repro_torch.models import params_from_jax

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(tree):
    return jax.tree.map(lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a),
                        tree)


def to_t(tree):
    """A reference tree of params as CPU tensors, bit for bit."""
    return tree_map(to_torch, host(tree))


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


def rel_close(got, want, tol=2e-2):
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def perturbed_norms(tree, seed=7):
    """``tree`` with every norm weight and bias drawn at random (they start
    at 0, or 1 and 0), so that a norm applied in the wrong place shows."""
    rng = np.random.default_rng(seed)

    def walk(t, path=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{path}/{i}") for i, v in enumerate(t))
        if "norm" in path:
            return (t + jnp.asarray(rng.standard_normal(t.shape) * 0.3, jnp.float32)).astype(t.dtype)
        return t

    return walk(tree)


def smoke(arch, **kw):
    return dataclasses.replace(jget(arch, smoke=True), **kw), dataclasses.replace(tget(arch, smoke=True), **kw)


@pytest.mark.parametrize("softcap,use_rope,hkv", [(0.0, False, 4), (50.0, False, 2), (0.0, True, 2)],
                         ids=["mha", "softcap-gqa", "rope-gqa"])
def test_cross_attention_block_matches_reference(softcap, use_rope, hkv):
    # seamless's decoder attends to 8 frames; q over 5 positions from 3.
    jcfg, tcfg = smoke("seamless-m4t-medium", attn_logit_softcap=softcap, n_kv_heads=hkv)
    p = jl.init_attention(jax.random.key(1), jcfg, jnp.float32)
    x, enc = normal(2, 2, 5, 64), normal(3, 2, 8, 64)
    kv = [normal(s, 2, 8, hkv, 16) for s in (4, 5)]
    pos = np.arange(3, 8, dtype=np.int32)
    want, wc = jl.attention_block(jcfg, p, jnp.asarray(x), positions=jnp.asarray(pos), causal=False,
                                  cross_kv=tuple(map(jnp.asarray, kv)), use_rope=use_rope)
    cache = {"k": torch.zeros(1)}
    got, gc = tl.attention_block(tcfg, to_t(p), torch.from_numpy(x), positions=torch.from_numpy(pos), causal=False,
                                 cross_kv=tuple(map(torch.from_numpy, kv)), use_rope=use_rope, cache=cache)
    assert wc is None and gc is cache  # no cache write: the cache comes back as it was given
    close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_logit_softcap_matches_reference(dtype):
    # gemma2's head: tied, softcap 30, here over a vocab of 500 padded to 512.
    jcfg, tcfg = smoke("gemma2-27b", dtype=dtype, vocab=500)
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp = perturbed_norms(jm.init(jax.random.key(0)))
    jp["embed"] = jp["embed"] * 20  # logits of ~N(0, 20): the cap bites
    x = normal(8, 2, 3, 64)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want = jm._logits(jp, jx)
    got = tm._logits(params_from_jax(host(jp), tcfg, "cpu"), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    live = got[..., :500].float()
    assert float(live.abs().max()) <= 30.0 and bool((got[..., 500:].float() <= -9e29).all())
    if dtype == "float32":
        close(got, want)
    else:
        rel_close(got[..., :500], want[..., :500])
    # without the cap the same head reads well past 30
    uncapped = TModel(dataclasses.replace(tcfg, final_logit_softcap=0.0), "cpu")._logits(
        params_from_jax(host(jp), tcfg, "cpu"), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert float(uncapped[..., :500].float().abs().max()) > 30.0


@pytest.mark.parametrize("kind", [("attn_local", "mlp"), ("attn", "mlp")], ids=["local", "global"])
def test_post_block_norm_block_matches_reference(kind):
    # One gemma2 block at 36 positions (window 16 on the local one, softcap
    # 50 on both), with random norm weights, so that the post norms count.
    jcfg, tcfg = smoke("gemma2-27b")
    p = perturbed_norms(jmodel.init_block(jax.random.key(2), jcfg, kind, cross=False, dtype=jnp.float32))
    assert {"post_norm1", "post_norm2"} <= set(p)
    x = normal(9, 2, 36, 64)
    pos = np.arange(36, dtype=np.int32)
    want, _, _ = jmodel.apply_block(jcfg, kind, p, jnp.asarray(x), positions=jnp.asarray(pos), causal=True,
                                    cache=None, cache_len=None)
    got, _, aux = tmodel.apply_block(tcfg, kind, to_t(p), torch.from_numpy(x), positions=torch.from_numpy(pos),
                                     causal=True, cache=None)
    assert aux is None
    close(got, want)
    # the same block without its post norms is another function
    bare = {k: v for k, v in to_t(p).items() if not k.startswith("post_norm")}
    other, _, _ = tmodel.apply_block(dataclasses.replace(tcfg, post_block_norm=False), kind, bare,
                                     torch.from_numpy(x), positions=torch.from_numpy(pos), causal=True, cache=None)
    assert float((other - got).abs().max()) > 1e-2


def test_sliding_window_decode_step_matches_reference():
    # A local layer's decode step at position 30 with window 16: one query
    # row over a cache of 31 rows, 15 of them outside the window.
    jcfg, tcfg = smoke("gemma2-27b")
    p = jl.init_attention(jax.random.key(3), jcfg, jnp.float32)
    kc, vc = normal(10, 2, 40, 4, 16), normal(11, 2, 40, 4, 16)
    x = normal(12, 2, 1, 64)
    pos = np.array([30], np.int32)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "len": jnp.asarray(30, jnp.int32)}
    want, wc = jl.attention_block(jcfg, p, jnp.asarray(x), positions=jnp.asarray(pos), causal=True, window=16,
                                  cache=jcache)
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy()),
              "len": torch.tensor(30, dtype=torch.int32)}
    got, gc = tl.attention_block(tcfg, to_t(p), torch.from_numpy(x), positions=torch.from_numpy(pos), causal=True,
                                 window=16, cache=tcache)
    close(got, want)
    close(gc["k"], wc["k"])
    assert int(gc["len"]) == int(wc["len"]) == 31


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    # seamless's encoder: 2 bidirectional layers over 8 frames, LayerNorm
    # (random weights), then enc_norm.
    jcfg, tcfg = smoke("seamless-m4t-medium", dtype=dtype)
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp = perturbed_norms(jm.init(jax.random.key(0)))
    src = normal(13, 2, 8, 64, scale=0.1)
    want = jm._encode(jp, jnp.asarray(src).astype(jcfg.dtype))
    got = tm._encode(params_from_jax(host(jp), tcfg, "cpu"), torch.from_numpy(src).to(getattr(torch, dtype)))
    assert got.shape == (2, 8, 64) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        close(got, want)
    else:
        rel_close(got, want)
    # bidirectional: the first frame's output depends on the last frame
    src2 = src.copy()
    src2[:, -1] += normal(19, 2, 64)
    got2 = tm._encode(params_from_jax(host(jp), tcfg, "cpu"), torch.from_numpy(src2).to(getattr(torch, dtype)))
    assert float((got2[:, 0] - got[:, 0]).float().abs().max()) > 1e-3


def test_vision_prefix_positions_match_reference():
    # internvl2: 8 projected patches, then 6 prompt tokens at positions 8..13,
    # then a decode step at 14; every layer's cached K (RoPE'd at those
    # positions) and the logits equal the reference's.
    jcfg, tcfg = smoke("internvl2-1b")
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(host(jp), tcfg, "cpu")
    toks = np.random.default_rng(14).integers(0, 512, (2, 7), dtype=np.int32)
    patches = normal(15, 2, 8, 64, scale=0.1)
    jcache, tcache = jm.init_cache(2, 20), tm.init_cache(2, 20)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks[:, :6]), jcache, patch_embeds=jnp.asarray(patches))
    tlg, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :6]), tcache, patch_embeds=torch.from_numpy(patches))
    assert int(tcache["len"]) == int(jcache["len"]) == 14
    close(tlg, jlg, 1e-4)
    close(tcache["layers"][0]["k"], jcache["decoder"]["body"][0]["k"][0], 1e-4)
    jlg, jcache = jm.decode_step(jp, jnp.asarray(toks[:, 6:]), jcache)
    tlg, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, 6:]), tcache)
    close(tlg, jlg, 1e-4)
    close(tcache["layers"][0]["k"], jcache["decoder"]["body"][0]["k"][0], 1e-4)
    # The decode step's position counts the patches: the same step taken at
    # position 6, as if there were no prefix, gives other logits.
    tcache2 = {**tcache, "len": torch.tensor(6, dtype=torch.int32)}
    other, _ = tm.decode_step(tp, torch.from_numpy(toks[:, 6:]), tcache2)
    assert float((other - tlg).abs().max()) > 1e-3


def test_frontend_inputs_are_required():
    for arch, name in (("seamless-m4t-medium", "src_embeds"), ("internvl2-1b", "patch_embeds")):
        tm = TModel(tget(arch, smoke=True), "cpu")
        tp = tm.init(torch.Generator().manual_seed(0))
        toks = torch.zeros((1, 3), dtype=torch.int32)
        with pytest.raises(ValueError, match=name):
            tm.forward(tp, toks)
        with pytest.raises(ValueError, match=name):
            tm.prefill(tp, toks, tm.init_cache(1, 16))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_kernel_path_launches_as_chip_smoke_expects(arch, monkeypatch):
    """Each arch's smoke config (fp32; gemma2's window 16, so 36 tokens) on
    the kernel path: a prefill and a decode step call each kernel wrapper
    exactly as ``chip_smoke.serve_launches`` counts for the card, and give
    the plain path's logits within the model tolerance."""
    serve_launches = _chip_smoke().serve_launches
    cfg = tget(arch, smoke=True)
    if cfg.moe.n_experts:  # nothing dropped, so that the two paths route the same tokens alike
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    tm = TModel(cfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    n = 2 * cfg.sliding_window + 4 if cfg.sliding_window else 9
    toks = torch.from_numpy(np.random.default_rng(16).integers(0, cfg.vocab, (2, n + 1), dtype=np.int32))
    fe = {}
    if cfg.is_encoder_decoder:
        fe["src_embeds"] = torch.from_numpy(normal(17, 2, cfg.frontend_len, cfg.d_model, scale=0.1))
    if cfg.frontend == "vision":
        fe["patch_embeds"] = torch.from_numpy(normal(18, 2, cfg.frontend_len, cfg.d_model, scale=0.1))
    m = n + 1 + (cfg.frontend_len if cfg.frontend == "vision" else 0)

    def run():
        cache = tm.init_cache(2, m)
        pre, cache = tm.prefill(tp, toks[:, :n], cache, **fe)
        counts.append(dict(calls))
        dec, _ = tm.decode_step(tp, toks[:, n:], cache)
        counts.append({k: v - counts[-1][k] for k, v in calls.items()})
        return pre, dec

    calls = {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0}
    counts = []
    with torch.no_grad():
        plain = run()
        assert all(c == {k: 0 for k in calls} for c in counts)  # the plain path calls no wrapper

        def counting(name, fn):
            def call(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return call

        monkeypatch.setattr(tl, "_use_kernel", lambda x: True)
        monkeypatch.setattr(krmsnorm, "rmsnorm", counting("rmsnorm", krmsnorm.rmsnorm))
        monkeypatch.setattr(kflash, "flash_attention", counting("flash_attention", kflash.flash_attention))
        monkeypatch.setattr(kdecode, "decode_attention", counting("decode_attention", kdecode.decode_attention))
        counts.clear()
        kern = run()
    assert tuple(counts) == serve_launches(cfg), (counts, serve_launches(cfg))
    for got, want in zip(kern, plain):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,lq,lk,off", [(1, 40, 48, 0), (2, 8, 12, 0), (2, 1, 40, 35)],
                         ids=["prompt past the window", "prompt", "step past the window"])
def test_flex_softcap_library_call_matches_plain(b, lq, lk, off):
    """The library call that ``chip_smoke.py`` times beside the flash kernel
    for gemma2, FlexAttention with ``chip_smoke.flex_softcap_kwargs`` (eager
    here, compiled on the card), computes the plain version's function,
    fp32 within 1e-5."""
    from torch.nn.attention.flex_attention import flex_attention

    from repro_torch.kernels import ref as kref

    g = torch.Generator().manual_seed(20)
    q, k, v = (torch.randn(b, h, n, 32, generator=g) for h, n in ((4, lq), (2, lk), (2, lk)))
    fkw = _chip_smoke().flex_softcap_kwargs(q, k, softcap=50.0, window=16, q_offset=off, kv_len=off + lq)
    want = kref.flash_attention_ref(q, k, v, causal=True, window=16, softcap=50.0, kv_len=off + lq, q_offset=off)
    np.testing.assert_allclose(flex_attention(q, k, v, **fkw).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
