"""The port's model (plain path, CPU) against ``repro.models.Model``.

Dense (llama3.2-3b smoke) and MoE: the granite-moe and deepseek-moe smoke
configs, and the ``moe`` and ``prefix_dense0`` families of
``tests/test_models.py``.  Weights come from the reference's own init,
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
from repro_torch import _bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import Model as TModel
from repro_torch.models import ModelConfig, MoECfg, params_from_jax

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
}
MOE_VARIANTS = ["granite-moe-smoke", "deepseek-moe-smoke", "moe", "prefix_dense0"]
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
    moe = kw.get("moe")
    jkw = {**kw, "moe": JMoE(**moe)} if moe else kw
    tkw = {**kw, "moe": MoECfg(**moe)} if moe else kw
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


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits(variant):
    jm, jp, tm, tp = setup(variant)
    toks = _tokens(0, 2, 12, jm.cfg.vocab)
    want, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    got = tm.forward(tp, torch.from_numpy(toks))
    assert got.dtype == getattr(torch, jm.cfg.dtype)
    _close(got, want, TOL[jm.cfg.dtype])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_and_cache(variant):
    jm, jp, tm, tp = setup(variant)
    tol = TOL[jm.cfg.dtype]
    b, m = 2, 16
    toks = _tokens(1, b, 9, jm.cfg.vocab)
    jcache, tcache = jm.init_cache(b, m), tm.init_cache(b, m)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)

    jl, jcache = jprefill(jp, jnp.asarray(toks[:, :5]), jcache)
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :5]), tcache)
    _close(tl, jl, tol)
    for t in range(5, 9):
        jl, jcache = jdecode(jp, jnp.asarray(toks[:, t : t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tcache)
        _close(tl, jl, tol)
    assert int(tcache["len"]) == int(jcache["len"]) == 9
    for layer, want in zip(tcache["layers"], jax_cache_layers(jcache, jm.cfg), strict=True):
        _close(layer["k"], want["k"], tol)
        _close(layer["v"], want["v"], tol)


def jax_cache_layers(jcache, cfg):
    """The reference's cache entries in ``cfg.layer_seq()`` order: the prefix's,
    then layer ``r`` of ``body[j]`` (stacked over repeats) for each repeat r."""
    dec = jcache["decoder"]
    out = list(dec["prefix"])
    for r in range(cfg.repeats):
        out += [{"k": dec["body"][j]["k"][r], "v": dec["body"][j]["v"][r]}
                for j in range(len(cfg.pattern))]
    return out


@pytest.mark.parametrize("variant", ["smoke", "gqa", *MOE_VARIANTS])
def test_decode_matches_forward(variant):
    # As tests/test_models.py: the port's decode path ≡ its own forward.
    _, _, tm, tp = setup(variant)
    b, l = 2, 16
    toks = torch.from_numpy(_tokens(2, b, l, tm.cfg.vocab))
    if tm.cfg.moe.n_experts:
        # Forward (T = 32) and decode (T = 2) route alike only where forward
        # drops nothing: the capacity factor of the smoke configs (1.25)
        # drops here, so give them the families' 4.0 for this check.
        tm = TModel(dataclasses.replace(tm.cfg, moe=dataclasses.replace(tm.cfg.moe, capacity_factor=4.0)),
                    device="cpu")
    full = tm.forward(tp, toks)
    cache = tm.init_cache(b, 64)
    lg, cache = tm.prefill(tp, toks[:, :8], cache)
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
            assert not a.float().any(), path  # norm weights start at zero (1 + w)
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
    "kw,item",
    [
        # jamba-style: a MoE FFN behind a mamba mixer waits for the mixer
        ({"pattern": (("mamba", "moe"),), "moe": MoECfg(n_experts=4, top_k=2, d_expert=8)}, "A5"),
        ({"pattern": (("mamba", "mlp"),)}, "A5"),
        ({"pattern": (("mlstm", "none"),)}, "A5"),
        ({"pattern": (("attn_local", "mlp"),), "sliding_window": 8}, "A6"),
        ({"is_encoder_decoder": True, "n_enc_layers": 1}, "A6"),
        ({"frontend": "vision"}, "A6"),
        ({"attn_logit_softcap": 50.0}, "A6"),
        ({"final_logit_softcap": 30.0}, "A6"),
        ({"post_block_norm": True}, "A6"),
    ],
)
def test_not_dense_raises_naming_roadmap_item(kw, item):
    cfg = ModelConfig(
        name="x", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, **kw
    )
    with pytest.raises(NotImplementedError, match=item):
        TModel(cfg, device="cpu")


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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_arch_configs_equal_the_reference(arch):
    for smoke in (False, True):
        j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd == td
    TModel(tget(arch), device="cpu")  # the full config is accepted (its weights are not made here)
