"""The port's model (plain path, CPU) against ``repro.models.Model``.

Dense (llama3.2-3b smoke), MoE (the granite-moe and deepseek-moe smoke
configs, and the ``moe`` and ``prefix_dense0`` families of
``tests/test_models.py``), recurrent (the xlstm-125m and jamba-v0.1-52b
smoke configs, also in bf16, and the ``mamba`` and ``xlstm`` families) and
the other families (the gemma2-27b smoke config, also in bf16, and the
nemotron-4-15b, qwen1.5-110b, internvl2-1b and seamless-m4t-medium ones,
and the ``gemma_style``, ``relu2_layernorm_bias``, ``encdec_audio`` and
``vlm`` families).  A model with a frontend gets the same numpy-made
``src_embeds`` or ``patch_embeds`` on both sides; a model with a sliding
window runs past it (36 tokens against gemma2's smoke window of 16), so
that the window's mask bites.
A recurrent layer's cache entry is ``{"state": <NamedTuple>}``, compared
field by field like the attention layers' ``k`` and ``v``.  Weights come from the reference's own init,
``Model(cfg).init(key(0))``, carried across with ``params_from_jax``;
tokens are made with numpy.
Tolerances: fp32 logits 1e-4 element-wise, because XLA and torch sum the
matmuls and softmaxes of a whole model in different orders.  bf16: relative
L2 error 2e-2 over each logits or cache tensor, as ``chip_smoke.py``'s
cross-check; element-wise, a single value can move by a few bf16 ulps (2^-8
relative each), because XLA keeps fp32 between the ops it fuses where torch
rounds every op's output to bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models import ModelConfig as JConfig
from repro.models import MoECfg as JMoE
from repro.models import SSMCfg as JSSM
from repro_torch import _bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import Model as TModel
from repro_torch.models import padded_vocab
from repro_torch.models import ModelConfig, MoECfg, SSMCfg, params_from_jax

# name: (arch, changes to its smoke config), or (None, a family's config).
# The MoE smoke configs keep the smoke reduction of their arch (granite: 9
# experts top-2, 4 heads over 4 KV heads; deepseek: 7 experts top-2 plus 2
# shared, a dense0 layer first), fp32.
FAMILY = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
              dtype="float32", remat=False)
VARIANTS = {
    "smoke": ("llama3.2-3b", {}),  # fp32, MHA (4 heads, 4 KV heads), 1 layer
    "gqa": ("llama3.2-3b", {"n_heads": 4, "n_kv_heads": 2, "n_layers": 3}),  # 3 repeats to unstack
    "bf16": ("llama3.2-3b", {"dtype": "bfloat16", "n_layers": 2}),
    "granite-moe-smoke": ("granite-moe-1b-a400m", {"n_layers": 2}),
    "deepseek-moe-smoke": ("deepseek-moe-16b", {"n_layers": 3}),
    # tests/test_models.py's families (capacity factor 4: nothing dropped)
    "moe": (None, {**FAMILY, "pattern": (("attn", "moe"),),
                   "moe": dict(n_experts=4, top_k=2, d_expert=32, n_shared=1, capacity_factor=4.0)}),
    "prefix_dense0": (None, {**FAMILY, "n_layers": 5, "prefix_pattern": (("attn", "dense0"),),
                             "pattern": (("attn", "moe"),),
                             "moe": dict(n_experts=4, top_k=2, d_expert=16, n_shared=2,
                                         capacity_factor=4.0)}),
    # The recurrent archs' smoke configs (xlstm: mLSTM + sLSTM, 4 heads of
    # 16; jamba: one 8-layer period, 7 mamba + 1 attention without RoPE, 4
    # MoE FFNs of 4 experts top-2), fp32 and bf16, and test_models.py's
    # recurrent families (chunk 4, so a 12-token forward runs 3 chunks).
    "xlstm-smoke": ("xlstm-125m", {}),
    "xlstm-smoke-bf16": ("xlstm-125m", {"dtype": "bfloat16"}),
    "jamba-smoke": ("jamba-v0.1-52b", {}),
    # bf16 at 2 layers, as llama's "bf16": XLA keeps fp32 between the ops it
    # fuses where torch rounds each op to bf16, and the difference compounds
    # with depth, through attention and mamba alike, and jamba's 8-layer smoke
    # config in bf16 is past 2e-2 from the reference once its MoE routing flips.
    "jamba-style-bf16": ("jamba-v0.1-52b", {"dtype": "bfloat16", "n_layers": 2,
                                            "pattern": (("mamba", "moe"), ("attn", "mlp"))}),
    "mamba": (None, {**FAMILY, "pattern": (("mamba", "mlp"),), "ssm": dict(chunk=4)}),
    "xlstm": (None, {**FAMILY, "d_ff": 0, "n_kv_heads": 4, "pattern": (("mlstm", "none"), ("slstm", "none")),
                     "ssm": dict(chunk=4)}),
    # The other families' smoke configs (gemma2: a local and a global
    # layer, window 16, both softcaps, post norms; nemotron: relu_sq and
    # LayerNorm; qwen: QKV bias; internvl2: 8 patches before the tokens, QKV
    # bias, GQA; seamless: 2 encoder layers, 1 decoder layer with
    # cross-attention over 8 frames, LayerNorm, GELU), gemma2 and seamless
    # also in bf16 (2 and 1 + 2 layers deep, as the other bf16 variants), and test_models.py's
    # families of the same features.
    "gemma2-smoke": ("gemma2-27b", {}),
    "gemma2-smoke-bf16": ("gemma2-27b", {"dtype": "bfloat16"}),
    "nemotron-smoke": ("nemotron-4-15b", {}),
    "qwen-smoke": ("qwen1.5-110b", {}),
    "internvl2-smoke": ("internvl2-1b", {}),
    "seamless-smoke": ("seamless-m4t-medium", {}),
    "seamless-smoke-bf16": ("seamless-m4t-medium", {"dtype": "bfloat16"}),
    "gemma_style": (None, {**FAMILY, "pattern": (("attn_local", "mlp"), ("attn", "mlp")), "sliding_window": 8,
                           "attn_logit_softcap": 50.0, "final_logit_softcap": 30.0, "post_block_norm": True,
                           "embed_scale": True, "tied_embeddings": True}),
    "relu2_layernorm_bias": (None, {**FAMILY, "activation": "relu_sq", "norm": "layernorm", "qkv_bias": True}),
    "encdec_audio": (None, {**FAMILY, "is_encoder_decoder": True, "n_enc_layers": 2, "frontend": "audio",
                            "frontend_len": 8}),
    "vlm": (None, {**FAMILY, "frontend": "vision", "frontend_len": 8}),
}
MOE_VARIANTS = ["granite-moe-smoke", "deepseek-moe-smoke", "moe", "prefix_dense0"]
RECURRENT_VARIANTS = ["xlstm-smoke", "jamba-smoke", "mamba", "xlstm"]
FAMILY_VARIANTS = ["gemma2-smoke", "nemotron-smoke", "qwen-smoke", "internvl2-smoke", "seamless-smoke",
                   "gemma_style", "relu2_layernorm_bias", "encdec_audio", "vlm"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tensors here are tiny: torch's CPU thread pool costs more than it
    # saves (over 100x on a shared machine), so run them on one thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host_tree(params):
    """The reference's params on the host; bf16 leaves as uint16 views."""

    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a

    return jax.tree.map(leaf, params)


def configs(variant):
    """The reference's config and the port's, equal field for field."""
    arch, kw = VARIANTS[variant]
    if arch is not None:
        return (dataclasses.replace(jget(arch, smoke=True), **kw),
                dataclasses.replace(tget(arch, smoke=True), **kw))
    jkw, tkw = dict(kw), dict(kw)
    for field, jcls, tcls in (("moe", JMoE, MoECfg), ("ssm", JSSM, SSMCfg)):
        if field in kw:
            jkw[field], tkw[field] = jcls(**kw[field]), tcls(**kw[field])
    return JConfig(name=variant, **jkw), ModelConfig(name=variant, **tkw)


def setup(variant):
    jcfg, tcfg = configs(variant)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = TModel(tcfg, device="cpu")
    tp = params_from_jax(host_tree(jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _close(got, want, tol):
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    if tol == TOL["bfloat16"]:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= tol, rel
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _tokens(seed, b, l, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, l), dtype=np.int32)


def frontend(cfg, b, seed=3):
    """The frontend's inputs for ``cfg`` (numpy fp32, N(0, 1) · 0.1, as the
    reference's serve draws them): ``src_embeds`` for an encoder-decoder
    model, ``patch_embeds`` for a vision model, else none."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.frontend_len, cfg.d_model)
    out = {}
    if cfg.is_encoder_decoder:
        out["src_embeds"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return out


def jfront(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def tfront(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def n_prefix(cfg):
    """The positions a vision model's patches take before the tokens."""
    return cfg.frontend_len if cfg.frontend == "vision" else 0


def seq_len(cfg, short):
    """``short`` tokens, or past twice the sliding window where there is one."""
    return 2 * cfg.sliding_window + 4 if cfg.sliding_window else short


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits(variant):
    jm, jp, tm, tp = setup(variant)
    toks = _tokens(0, 2, seq_len(jm.cfg, 12), jm.cfg.vocab)
    fe = frontend(jm.cfg, 2)
    want, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks), **jfront(fe))
    got = tm.forward(tp, torch.from_numpy(toks), **tfront(fe))
    assert got.shape == (2, n_prefix(jm.cfg) + toks.shape[1], padded_vocab(jm.cfg))
    assert got.dtype == getattr(torch, jm.cfg.dtype)
    _close(got, want, TOL[jm.cfg.dtype])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_and_cache(variant):
    jm, jp, tm, tp = setup(variant)
    tol = TOL[jm.cfg.dtype]
    # prefill 5 tokens and decode 4; with a sliding window, prefill past it
    # and decode on past twice it
    n0 = jm.cfg.sliding_window + 4 if jm.cfg.sliding_window else 5
    b, n1 = 2, n0 + 4
    m = n_prefix(jm.cfg) + n1 + 7
    toks = _tokens(1, b, n1, jm.cfg.vocab)
    fe = frontend(jm.cfg, b)
    jcache, tcache = jm.init_cache(b, m), tm.init_cache(b, m)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)

    jl, jcache = jprefill(jp, jnp.asarray(toks[:, :n0]), jcache, **jfront(fe))
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :n0]), tcache, **tfront(fe))
    _close(tl, jl, tol)
    for t in range(n0, n1):
        jl, jcache = jdecode(jp, jnp.asarray(toks[:, t : t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tcache)
        _close(tl, jl, tol)
    assert int(tcache["len"]) == int(jcache["len"]) == n_prefix(jm.cfg) + n1
    assert sorted(tcache) == sorted(["len", "layers"] + (["enc_out"] if "enc_out" in jcache else []))
    if "enc_out" in jcache:  # the encoder's output, which every decoder call reads
        _close(tcache["enc_out"], jcache["enc_out"], tol)
    for (mixer, _), layer, want in zip(jm.cfg.layer_seq(), tcache["layers"],
                                       jax_cache_layers(jcache, jm.cfg), strict=True):
        # {"k", "v"} for attention, {"state": <NamedTuple>} for a recurrent mixer
        assert sorted(layer) == (["k", "v"] if mixer in ("attn", "attn_local") else ["state"]), mixer
        got, exp = _bridge.tree_flatten_with_path(layer), jax.tree_util.tree_flatten_with_path(want)[0]
        assert [n for n, _ in got] == ["/".join(str(getattr(k, "key", getattr(k, "name", None))) for k in p)
                                       for p, _ in exp], mixer
        for (name, a), (_, b) in zip(got, exp):
            assert str(a.dtype)[6:] == str(b.dtype), name  # the states keep the reference's dtypes
            _close(a, b, tol)


def jax_cache_layers(jcache, cfg):
    """The reference's cache entries in ``cfg.layer_seq()`` order: the prefix's,
    then layer ``r`` of ``body[j]`` (stacked over repeats) for each repeat r."""
    dec = jcache["decoder"]
    out = list(dec["prefix"])
    for r in range(cfg.repeats):
        out += [jax.tree.map(lambda a: a[r], dec["body"][j]) for j in range(len(cfg.pattern))]
    return out


@pytest.mark.parametrize("variant", ["smoke", "gqa", *MOE_VARIANTS, *RECURRENT_VARIANTS, *FAMILY_VARIANTS])
def test_decode_matches_forward(variant):
    # As tests/test_models.py: the port's decode path ≡ its own forward.
    _, _, tm, tp = setup(variant)
    b, l = 2, seq_len(tm.cfg, 16)
    toks = torch.from_numpy(_tokens(2, b, l, tm.cfg.vocab))
    fe = tfront(frontend(tm.cfg, b))
    if tm.cfg.moe.n_experts:
        # Forward (T = 32) and decode (T = 2) route alike only where forward
        # drops nothing: the capacity factor of the smoke configs (1.25)
        # drops here, so give them the families' 4.0 for this check.
        tm = TModel(dataclasses.replace(tm.cfg, moe=dataclasses.replace(tm.cfg.moe, capacity_factor=4.0)),
                    device="cpu")
    full = tm.forward(tp, toks, **fe)
    cache = tm.init_cache(b, n_prefix(tm.cfg) + 64)
    lg, cache = tm.prefill(tp, toks[:, :8], cache, **fe)
    outs = [lg]
    for t in range(8, l):
        lg, cache = tm.decode_step(tp, toks[:, t : t + 1], cache)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full[:, -(l - 7) :]).abs().max()) < 2e-3


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_matches_reference_layout(variant):
    jm, jp, tm, tp = setup(variant)
    mine = tm.init(torch.Generator().manual_seed(0))
    flat_ref = {}

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            flat_ref[path] = (a, b)

    walk(mine, tp)
    for path, (a, b) in flat_ref.items():
        if "norm" in path:
            # rmsnorm's weights start at zero (it scales by 1 + w); LayerNorm's
            # at one, with a zero bias
            one = tm.cfg.norm == "layernorm" and path.endswith("/w")
            assert bool((a.float() == float(one)).all()), path
        elif path.endswith("/w") or path == "/embed":
            d_in = a.shape[-1] if path == "/embed" else a.shape[0]
            # the reference's scale, 1/sqrt(d_in), checked by sample std
            assert abs(float(a.float().std()) * d_in**0.5 - 1.0) < 0.1, path


def test_bf16_leaves_cross_bit_for_bit():
    jm, jp, tm, tp = setup("bf16")
    want = np.asarray(jp["embed"]).view(np.uint16)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bridge.to_numpy(tp["embed"]), want)


@pytest.mark.parametrize(
    "kw",
    [
        # The six A6 cases test_not_dense_raises_naming_roadmap_item used to
        # refuse: a sliding-window layer, an encoder-decoder model, the vision
        # frontend, each logit softcap and the post-block norms.  They run now.
        {"pattern": (("attn_local", "mlp"),), "sliding_window": 8},
        {"is_encoder_decoder": True, "n_enc_layers": 1},
        {"frontend": "vision"},
        {"attn_logit_softcap": 50.0},
        {"final_logit_softcap": 30.0},
        {"post_block_norm": True},
    ],
    ids=["attn_local", "encoder-decoder", "vision", "attn-softcap", "final-softcap", "post-block-norm"],
)
def test_family_config_that_was_refused_now_runs(kw):
    cfg = ModelConfig(
        name="x", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, dtype="float32", **kw
    )
    m = TModel(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(5, 2, 20, cfg.vocab))
    fe = tfront(frontend(cfg, 2))
    logits = m.forward(p, toks, **fe)
    assert logits.shape == (2, n_prefix(cfg) + 20, 512) and bool(logits.isfinite().all())
    if cfg.final_logit_softcap:
        assert float(logits.abs().max()) <= cfg.final_logit_softcap
    cache = m.init_cache(2, n_prefix(cfg) + 24)
    lg, cache = m.prefill(p, toks[:, :18], cache, **fe)
    lg, cache = m.decode_step(p, toks[:, 18:19], cache)
    assert bool(lg.isfinite().all()) and int(cache["len"]) == n_prefix(cfg) + 19
    with pytest.raises(ValueError, match="unknown mixer"):
        TModel(dataclasses.replace(cfg, pattern=(("attn_global", "mlp"),)), device="cpu")


def test_moe_config_that_was_refused_now_runs():
    # The config the A4 case above used to refuse: attention + a MoE FFN.
    cfg = ModelConfig(
        name="x", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        pattern=(("attn", "moe"),), moe=MoECfg(n_experts=4, top_k=2, d_expert=8), dtype="float32",
    )
    m = TModel(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert p["layers"][0]["ffn"]["router"]["w"].dtype == torch.float32
    toks = torch.from_numpy(_tokens(4, 2, 8, cfg.vocab))
    logits = m.forward(p, toks)
    assert logits.shape == (2, 8, 512) and bool(logits.isfinite().all())
    loss, metrics = m.loss(p, {"tokens": toks, "labels": toks})
    assert bool(loss.isfinite()) and float(metrics["aux"]) > 0.0


@pytest.mark.parametrize(
    "kw",
    [
        # The three A5 cases test_not_dense_raises_naming_roadmap_item used to
        # refuse: a jamba-style MoE FFN behind a mamba mixer, mamba + MLP, and
        # an mLSTM block with no FFN.  They run now.
        {"pattern": (("mamba", "moe"),), "moe": MoECfg(n_experts=4, top_k=2, d_expert=8)},
        {"pattern": (("mamba", "mlp"),)},
        {"pattern": (("mlstm", "none"),)},
    ],
    ids=["mamba-moe", "mamba-mlp", "mlstm-none"],
)
def test_recurrent_config_that_was_refused_now_runs(kw):
    cfg = ModelConfig(
        name="x", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, dtype="float32", **kw
    )
    m = TModel(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(5, 2, 8, cfg.vocab))
    logits = m.forward(p, toks)
    assert logits.shape == (2, 8, 512) and bool(logits.isfinite().all())
    cache = m.init_cache(2, 12)
    assert all(sorted(c) == ["state"] for c in cache["layers"])
    lg, cache = m.prefill(p, toks[:, :5], cache)
    lg, cache = m.decode_step(p, toks[:, 5:6], cache)
    assert bool(lg.isfinite().all()) and int(cache["len"]) == 6


# test_arch_smoke.py's full-config checks, on the port's registry.
ASSIGNMENT = {  # (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab)
    "llama3.2-3b": (28, 3072, 24, 8, 8192, 128256),
    "xlstm-125m": (12, 768, 4, 4, 0, 50304),
    "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
    "deepseek-moe-16b": (28, 2048, 16, 16, 10944, 102400),
    "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
    "seamless-m4t-medium": (12, 1024, 16, 16, 4096, 256206),
    "gemma2-27b": (46, 4608, 32, 16, 36864, 256000),
    "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000),
    "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
    "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
}


@pytest.mark.parametrize("arch", sorted(ASSIGNMENT))
def test_full_config_exactness(arch):
    from repro_torch.configs import ARCHS

    assert sorted(ARCHS) == sorted(ASSIGNMENT)
    cfg = tget(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab)
    assert got == ASSIGNMENT[arch]


def test_moe_configs():
    g = tget("granite-moe-1b-a400m").moe
    assert (g.n_experts, g.top_k, g.d_expert) == (32, 8, 512)
    d = tget("deepseek-moe-16b").moe
    assert (d.n_experts, d.top_k, d.n_shared, d.d_expert) == (64, 6, 2, 1408)
    j = tget("jamba-v0.1-52b").moe
    assert (j.n_experts, j.top_k) == (16, 2)


def test_jamba_interleave():
    cfg = tget("jamba-v0.1-52b")
    seq = cfg.layer_seq()
    assert len(seq) == 32
    assert sum(1 for m, _ in seq if m == "attn") == 4  # 1:7 attn:mamba
    assert sum(1 for _, f in seq if f == "moe") == 16  # every other layer
    assert not cfg.use_rope


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_recurrent_arch_configs_equal_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(jget(arch, smoke=smoke)) == dataclasses.asdict(tget(arch, smoke=smoke))
    # The full configs are accepted; jamba's 51.6 B params are not made here.
    TModel(tget("jamba-v0.1-52b"), device="cpu")
    if arch == "xlstm-125m":  # 0.12 B params: init, prefill and decode at full size on the CPU
        m = TModel(tget(arch), device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        toks = torch.from_numpy(_tokens(6, 1, 5, m.cfg.vocab))
        cache = m.init_cache(1, 6)
        with torch.inference_mode():
            lg, cache = m.prefill(p, toks, cache)
            lg, cache = m.decode_step(p, toks[:, -1:], cache)
        assert lg.shape == (1, 1, padded_vocab(m.cfg)) and bool(lg[..., :50304].isfinite().all())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_arch_configs_equal_the_reference(arch):
    for smoke in (False, True):
        j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd == td
    TModel(tget(arch), device="cpu")  # the full config is accepted (its weights are not made here)


@pytest.mark.parametrize("arch", ["gemma2-27b", "nemotron-4-15b", "qwen1.5-110b", "internvl2-1b",
                                  "seamless-m4t-medium"])
def test_family_arch_configs_equal_the_reference(arch):
    for smoke in (False, True):
        j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.repeats, j.q_dim, j.kv_dim, j.layer_seq()) == (t.repeats, t.q_dim, t.kv_dim, t.layer_seq())
    TModel(tget(arch), device="cpu")  # the full config is accepted (its weights are not made here)


def test_xlstm_bf16_drifts_from_fp32_no_further_than_the_reference():
    """xlstm-125m at full width (4 of its 12 layers), bf16 against the same
    weights in fp32, on each side: the mLSTM's normaliser and the exponential
    gates amplify bf16 rounding (the reference's own logits drift by more
    than 5e-3 here), and the port's may drift at most 1.25x as far."""
    jcfg = dataclasses.replace(jget("xlstm-125m"), n_layers=4)
    tcfg = dataclasses.replace(tget("xlstm-125m"), n_layers=4)
    jp = JModel(jcfg).init(jax.random.key(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = _tokens(7, 2, 32, jcfg.vocab)
    v = jcfg.vocab

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def ref_logits(cfg, p):
        return np.asarray(jax.jit(JModel(cfg).forward)(p, jnp.asarray(toks))[0][:, -1, :v], np.float32)

    def port_logits(cfg, p):
        with torch.inference_mode():
            return TModel(cfg, "cpu").forward(p, torch.from_numpy(toks))[:, -1, :v].float().numpy()

    c32 = dataclasses.replace(tcfg, dtype="float32")
    ref_drift = rel(ref_logits(jcfg, jp), ref_logits(dataclasses.replace(jcfg, dtype="float32"), jp32))
    port_drift = rel(port_logits(tcfg, params_from_jax(host_tree(jp), tcfg, "cpu")),
                     port_logits(c32, params_from_jax(host_tree(jp32), c32, "cpu")))
    assert 5e-3 < ref_drift and port_drift <= 1.25 * ref_drift, (port_drift, ref_drift)
