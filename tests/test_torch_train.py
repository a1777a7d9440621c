"""Training on the port (CPU, plain path) against the JAX package.

Weights are the reference's own init carried across with ``params_from_jax``;
tokens and labels are made with numpy.  Tolerances:

* ``Model.loss`` in fp32: 2e-5 relative (``TOL`` of ``tests/test_kernels.py``);
  each grad leaf atol 1e-5 + rtol 1e-4 (XLA and torch sum the backward's
  matmuls in other orders).  bf16: loss 2e-2 relative and each grad leaf
  2e-2 by relative L2 (the bf16 ``TOL``; XLA keeps fp32 between fused ops
  where torch rounds each op's output).
* The slice as a whole (3 reference steps, then both packages resume from
  that checkpoint for 2 more): losses 2e-5 relative; params 1e-5 uncompressed,
  1e-4 compressed (an int8 rounding that an ulp of gradient tips over a half
  moves one element by one step, whose AdamW update is at most ~lr, 3e-5 a
  step, in the 2 steps).
* The kernel path rehearsed on the CPU (the kernels' wrappers return their
  plain versions for CPU tensors) against the plain path: fp32 2e-5
  relative on the loss, atol 1e-5 + rtol 1e-4 on each grad leaf, as above
  (the plain attention and the flash kernel's plain version order their
  sums differently).
* The recurrent archs (mamba, mLSTM, sLSTM) as the dense ones: the port's
  Hillis–Steele scan and the reference's ``associative_scan`` associate
  in other trees, within the same fp32 tolerances.
* The other families (gemma2, nemotron, qwen, internvl2, seamless) as the
  dense ones, with the same numpy-made ``src_embeds`` or ``patch_embeds``
  on both sides; a vision model's CE is over its token positions only.
"""

import contextlib
import dataclasses
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _chip_smoke

from repro.configs import get_config as jget
from repro.launch.train import train as jtrain
from repro.models import Model as JModel
from repro.models import ModelConfig as JConfig
from repro.models import MoECfg as JMoE
from repro.models import SSMCfg as JSSM
from repro_torch import _bridge
from repro_torch.ckpt import latest_step
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch.steps import make_grad_step, make_train_step
from repro_torch.launch.train import Trainer
from repro_torch.launch.train import main as tmain
from repro_torch.launch.train import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.models import ModelConfig as TConfig
from repro_torch.models import MoECfg as TMoE
from repro_torch.models import SSMCfg as TSSM
from repro_torch.models import params_from_jax, params_to_jax
from repro_torch.optim import AdamWConfig
from repro_torch.workflow.fault import RetryPolicy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCH = "llama3.2-3b"
RUN = dict(smoke=True, n_pods=2, global_batch=4, seq_len=32, log_every=100)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(tree):
    return jax.tree.map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a), tree
    )


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def batch_np(seed, b, l, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, l), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, 3] = labels[1, -1] = -1  # ignored positions
    return {"tokens": toks, "labels": labels}


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


VARIANTS = {
    "smoke": {},  # fp32, 1 layer, MHA
    "gqa": {"n_heads": 4, "n_kv_heads": 2, "n_layers": 3},
    "gqa-remat": {"n_heads": 4, "n_kv_heads": 2, "n_layers": 3, "remat": True},
    "bf16": {"dtype": "bfloat16", "n_layers": 2},
}


def setup(kw):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(tget(ARCH, smoke=True), **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    return jm, jp, TModel(tcfg, "cpu"), params_from_jax(host(jp), tcfg, "cpu")


# The leaves that stay fp32 in a bf16 model: a MoE router, and the recurrent
# mixers' A_log, D, dt bias, mLSTM gates and sLSTM gate biases.
FP32_LEAVES = ("router/w", "A_log", "/D", "dt_proj/b", "i_gate/w", "f_gate/w",
               "g_i/b", "g_f/b", "g_z/b", "g_o/b")


def leaf_dtype(name, dtype):
    return torch.float32 if name.endswith(FP32_LEAVES) else getattr(torch, dtype)


def assert_grads(tgrads, jgrads, tcfg, dtype, floor=0.0):
    """Each leaf against the reference's; in bf16 by relative L2, against
    ``max(|reference leaf|, floor)``."""
    tj = params_to_jax(tgrads, tcfg)
    names = [n for n, _ in _bridge.tree_flatten_with_path(tj)]
    assert len(names) == len(jax.tree.leaves(jgrads))
    for name, a, b in zip(names, _bridge.tree_leaves(tj), jax.tree.leaves(jgrads)):
        # grads keep their params' dtype: the model's, and fp32 where the param is
        assert str(a.dtype) == f"torch.{b.dtype}", name
        assert a.dtype == leaf_dtype(name, dtype), name
        a, b = f32(a), f32(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=name)
        else:
            assert np.linalg.norm(a - b) <= TOL[dtype] * max(np.linalg.norm(b), floor), name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_value_and_grad(variant):
    jm, jp, tm, tp = setup(VARIANTS[variant])
    batch = batch_np(0, 2, 12, jm.cfg.vocab)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, to_j(batch))
    tg, tmet = make_grad_step(tm)(tp, to_t(batch))
    assert sorted(tmet) == ["aux", "ce", "loss", "tokens"]
    for k in ("loss", "ce"):
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(float(tmet[k]), float(jl if k == "loss" else jmet[k]),
                                   rtol=TOL[jm.cfg.dtype], err_msg=k)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 2 * 12 - 2
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    assert_grads(tg, jg, tm.cfg, jm.cfg.dtype)


def test_loss_chunks_like_the_reference():
    jm, jp, tm, tp = setup(VARIANTS["smoke"])
    batch = batch_np(1, 2, 12, jm.cfg.vocab)
    jl, _ = jm.loss(jp, to_j(batch), seq_chunk=5)  # chunks of 5, 5, 2
    tl, _ = tm.loss(tp, to_t(batch), seq_chunk=5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL["float32"])
    whole, _ = tm.loss(tp, to_t(batch))
    np.testing.assert_allclose(float(tl), float(whole), rtol=TOL["float32"])


# MoE: the arch smoke configs (granite: 9 experts top-2; deepseek: 7 top-2
# plus 2 shared, a dense0 layer first), with and without remat.  The aux
# loss enters the loss as router_aux_weight × aux and reaches the router's
# gradient; the slot assignment drops choices at these sizes, as the
# reference does.
MOE_VARIANTS = {
    "granite": ("granite-moe-1b-a400m", {"n_layers": 2}),
    "granite-remat": ("granite-moe-1b-a400m", {"n_layers": 2, "remat": True}),
    "deepseek": ("deepseek-moe-16b", {"n_layers": 3}),
    "deepseek-remat": ("deepseek-moe-16b", {"n_layers": 3, "remat": True}),
    "granite-bf16": ("granite-moe-1b-a400m", {"n_layers": 2, "dtype": "bfloat16"}),
}


def moe_setup(variant):
    arch, kw = MOE_VARIANTS[variant]
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tget(arch, smoke=True), **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    return jm, jp, TModel(tcfg, "cpu"), params_from_jax(host(jp), tcfg, "cpu")


@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
def test_moe_loss_aux_and_grads_match_value_and_grad(variant):
    jm, jp, tm, tp = moe_setup(variant)
    dtype = jm.cfg.dtype
    batch = batch_np(7, 2, 12, jm.cfg.vocab)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, to_j(batch))
    tg, tmet = make_grad_step(tm)(tp, to_t(batch))
    for k in ("loss", "ce", "aux"):
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(float(tmet[k]), float(jl if k == "loss" else jmet[k]),
                                   rtol=TOL[dtype], err_msg=k)
    assert float(tmet["aux"]) > 0.0
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    assert_grads(tg, jg, tm.cfg, dtype)
    routers = [l["ffn"]["router"]["w"] for l, kind in zip(tg["layers"], tm.cfg.layer_seq())
               if kind[1] == "moe"]
    assert routers and all(r.dtype == torch.float32 and float(r.abs().max()) > 0 for r in routers)


# The recurrent archs: the xlstm-125m and jamba-v0.1-52b smoke configs and
# test_models.py's mamba and xlstm families, with and without remat.  Jamba's
# smoke config drops MoE choices at its capacity factor, as the reference does.
REC_VARIANTS = {
    "xlstm-smoke": ("xlstm-125m", {}),
    "jamba-smoke": ("jamba-v0.1-52b", {}),
    "mamba": (None, "mamba"),
    "xlstm": (None, "xlstm"),
}


def rec_setup(variant, remat):
    arch, kw = REC_VARIANTS[variant]
    if arch is None:
        jcfg, tcfg = family_configs(kw)
    else:
        jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jcfg, tcfg = dataclasses.replace(jcfg, remat=remat), dataclasses.replace(tcfg, remat=remat)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    return jm, jp, TModel(tcfg, "cpu"), params_from_jax(host(jp), tcfg, "cpu")


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("variant", sorted(REC_VARIANTS))
def test_recurrent_loss_and_grads_match_value_and_grad(variant, remat):
    jm, jp, tm, tp = rec_setup(variant, remat)
    batch = batch_np(9, 2, 12, jm.cfg.vocab)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, to_j(batch))
    tg, tmet = make_grad_step(tm)(tp, to_t(batch))
    for k in ("loss", "ce", "aux"):
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(float(tmet[k]), float(jl if k == "loss" else jmet[k]),
                                   rtol=TOL["float32"], err_msg=k)
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    assert_grads(tg, jg, tm.cfg, "float32")
    for name, g in _bridge.tree_flatten_with_path(tg):
        if "/mixer/" in name and not name.endswith(("conv_b", "/b")):
            assert float(g.abs().max()) > 0.0, name  # the mixers' weights get a gradient


def test_mlstm_grads_stay_finite_in_a_long_chunk():
    """Queue C of ROADMAP.md: the reference's mLSTM exponentiates its
    above-diagonal weights before masking them, and past ~130 tokens in one
    chunk they overflow and its grads turn NaN (xlstm-125m's chunk is 512);
    the port masks first.  The reference's grads at 256 tokens in one chunk
    are not finite (asserted, to record it); at that chunk the port's must
    be finite and equal the reference's at chunk 16, where nothing overflows
    (the chunked form is exact), within fp32 TOL by relative L2 (element-wise
    the mLSTM is ill-conditioned where its normaliser is small: chunkings
    that stabilise at other log-maxes move single elements by ~1e-4)."""
    from repro.models import recurrent as jrec
    from repro_torch.models import recurrent as trec

    jcfg = dataclasses.replace(jget("xlstm-125m", smoke=True), ssm=JSSM(chunk=16))
    tcfg = dataclasses.replace(tget("xlstm-125m", smoke=True), ssm=TSSM(chunk=256))
    jp = jrec.init_mlstm(jax.random.key(3), jcfg, jnp.float32)
    x = np.random.default_rng(11).standard_normal((2, 256, jcfg.d_model)).astype(np.float32)
    proj = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jrec.mlstm_mix(jcfg, p, x)[0] * proj)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    # The divergence this test records: the reference in one chunk of 256.
    long = dataclasses.replace(jcfg, ssm=JSSM(chunk=256))
    jlong = jax.grad(lambda p, x: jnp.sum(jrec.mlstm_mix(long, p, x)[0] * proj))(jp, jnp.asarray(x))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jlong))
    tp = _bridge.tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(), jp)
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = trec.mlstm_mix(tcfg, tp, tx)
    tg = torch.autograd.grad((y * torch.from_numpy(proj)).sum(), [tx, *_bridge.tree_leaves(tp)])
    want = [jgx, *jax.tree.leaves(jgp)]
    assert len(tg) == len(want) == 7
    for a, b in zip(tg, want):
        b = np.asarray(b)
        assert bool(a.isfinite().all())
        assert np.linalg.norm(a.numpy() - b) <= TOL["float32"] * np.linalg.norm(b)


def test_xlstm_bf16_grads_drift_from_fp32_as_the_references_do():
    """xlstm-125m at full width (4 of its 12 layers, 2 x 128 tokens), the bf16
    gradient against the fp32 gradient of the same weights, on each side:
    the exponential gates and the mLSTM's normaliser amplify bf16 rounding
    through the steps and layers, so the reference's own bf16 gradient is
    more than 0.1 from its fp32 one by relative L2, and the port's drifts as
    far within a factor of 2 (the drift is chaotic: two sides that round
    apart land apart).  On the card, at 12 layers and 2 x 512 tokens, either
    path's is 1.36-1.42, so ``chip_smoke.py`` phase 13 prints TR-xlstm's bf16
    kernel-vs-plain leaves and holds them in fp32.  The reference runs its mLSTM at chunk 16, where its
    gradient does not overflow (queue C)."""
    jcfg = dataclasses.replace(jget("xlstm-125m"), n_layers=4, ssm=JSSM(chunk=16))
    tcfg = dataclasses.replace(tget("xlstm-125m"), n_layers=4)
    jp = JModel(jcfg).init(jax.random.key(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = batch_np(7, 2, 128, jcfg.vocab)

    def whole(xs, ys):
        return float(np.sqrt(sum(np.sum((x - y) ** 2) for x, y in zip(xs, ys)) / sum(np.sum(y ** 2) for y in ys)))

    def grads(dtype, p):
        jc, tc = dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(tcfg, dtype=dtype)
        jg = jax.jit(jax.grad(lambda p, b: JModel(jc).loss(p, b)[0]))(p, to_j(batch))
        tg, _ = make_grad_step(TModel(tc, "cpu"))(params_from_jax(host(p), tc, "cpu"), to_t(batch))
        return [f32(g) for g in jax.tree.leaves(jg)], [f32(g) for g in _bridge.tree_leaves(tg)]

    (j16, t16), (j32, t32) = grads("bfloat16", jp), grads("float32", jp32)
    ref_drift, port_drift = whole(j16, j32), whole(t16, t32)
    assert 0.1 < ref_drift and ref_drift / 2 <= port_drift <= 2 * ref_drift, (port_drift, ref_drift)


def test_recurrent_bf16_keeps_its_fp32_leaves_and_grads():
    # xlstm's smoke config in bf16: the mLSTM gates and sLSTM biases stay
    # fp32, with fp32 grads, the rest bf16; loss and grads within bf16 TOL.
    jcfg = dataclasses.replace(jget("xlstm-125m", smoke=True), dtype="bfloat16")
    tcfg = dataclasses.replace(tget("xlstm-125m", smoke=True), dtype="bfloat16")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm, tp = TModel(tcfg, "cpu"), params_from_jax(host(jp), tcfg, "cpu")
    batch = batch_np(10, 2, 12, jcfg.vocab)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, to_j(batch))
    tg, tmet = make_grad_step(tm)(tp, to_t(batch))
    np.testing.assert_allclose(float(tmet["loss"]), float(jl), rtol=TOL["bfloat16"])
    # The sLSTM input-gate bias's grad is rounding noise on both sides (~1e-9,
    # a millionth of the whole gradient): from a zero state n stays >= 1, so
    # h = o·c/n, a weighted mean of the z_t in which a shift of every i_t by
    # one bias cancels.  Such leaves are held against a floor of 1e-6 of the
    # whole gradient's norm.
    total = float(np.sqrt(sum(np.sum(f32(g) ** 2) for g in jax.tree.leaves(jg))))
    assert_grads(tg, jg, tcfg, "bfloat16", floor=1e-6 * total)
    assert any(g.dtype == torch.float32 for g in _bridge.tree_leaves(tg))


# The other families: the smoke configs of the five archs the A6 slice
# ports (gemma2 at 36 tokens, past its window of 16), with and without remat
# (which recomputes the encoder's blocks and the cross-attention's too).
FAMILY_ARCHS = {"gemma2": "gemma2-27b", "nemotron": "nemotron-4-15b", "qwen": "qwen1.5-110b",
                "internvl2": "internvl2-1b", "seamless": "seamless-m4t-medium"}


def frontend_np(cfg, b, seed=5):
    """``src_embeds`` / ``patch_embeds`` for ``cfg`` (numpy fp32), or none."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.frontend_len, cfg.d_model)
    out = {}
    if cfg.is_encoder_decoder:
        out["src_embeds"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_loss_and_grads_match_value_and_grad(family, remat):
    arch = FAMILY_ARCHS[family]
    jcfg = dataclasses.replace(jget(arch, smoke=True), remat=remat)
    tcfg = dataclasses.replace(tget(arch, smoke=True), remat=remat)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm, tp = TModel(tcfg, "cpu"), params_from_jax(host(jp), tcfg, "cpu")
    l = 2 * jcfg.sliding_window + 4 if jcfg.sliding_window else 12
    batch = {**batch_np(12, 2, l, jcfg.vocab), **frontend_np(jcfg, 2)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, to_j(batch))
    tg, tmet = make_grad_step(tm)(tp, to_t(batch))
    for k in ("loss", "ce"):
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(float(tmet[k]), float(jl if k == "loss" else jmet[k]),
                                   rtol=TOL["float32"], err_msg=k)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 2 * l - 2  # the token region only
    assert_grads(tg, jg, tm.cfg, "float32")
    for name, g in _bridge.tree_flatten_with_path(tg):
        if name.startswith(("enc_layers", "vision_proj")) or "/cross/" in name or "post_norm" in name:
            assert float(g.abs().max()) > 0.0, name  # the new leaves get a gradient


# The families of tests/test_models.py.
BASE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
            dtype="float32", remat=False)
FAMILIES = {
    "dense": BASE,
    "relu2_layernorm_bias": {**BASE, "activation": "relu_sq", "norm": "layernorm", "qkv_bias": True},
    "moe": {**BASE, "pattern": (("attn", "moe"),),
            "moe": dict(n_experts=4, top_k=2, d_expert=32, n_shared=1, capacity_factor=4.0)},
    "prefix_dense0": {**BASE, "n_layers": 5, "prefix_pattern": (("attn", "dense0"),),
                      "pattern": (("attn", "moe"),),
                      "moe": dict(n_experts=4, top_k=2, d_expert=16, n_shared=2, capacity_factor=4.0)},
    "mamba": {**BASE, "pattern": (("mamba", "mlp"),), "ssm": dict(chunk=4)},
    "xlstm": {**BASE, "d_ff": 0, "n_kv_heads": 4, "pattern": (("mlstm", "none"), ("slstm", "none")),
              "ssm": dict(chunk=4)},
    "gemma_style": {**BASE, "pattern": (("attn_local", "mlp"), ("attn", "mlp")), "sliding_window": 8,
                    "attn_logit_softcap": 50.0, "final_logit_softcap": 30.0, "post_block_norm": True,
                    "embed_scale": True, "tied_embeddings": True},
    "encdec_audio": {**BASE, "is_encoder_decoder": True, "n_enc_layers": 2, "frontend": "audio",
                     "frontend_len": 8},
    "vlm": {**BASE, "frontend": "vision", "frontend_len": 8},
}


def family_configs(family):
    kw = FAMILIES[family]
    jkw, tkw = dict(kw), dict(kw)
    for field, jcls, tcls in (("moe", JMoE, TMoE), ("ssm", JSSM, TSSM)):
        if field in kw:
            jkw[field], tkw[field] = jcls(**kw[field]), tcls(**kw[field])
    return JConfig(name=family, **jkw), TConfig(name=family, **tkw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_finite_grads(family):
    jcfg, tcfg = family_configs(family)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm, tp = TModel(tcfg, "cpu"), params_from_jax(host(jp), tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 16), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks, **frontend_np(tcfg, 2)}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, to_j(batch))
    grads, metrics = make_grad_step(tm)(tp, to_t(batch))
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(g).all()) for g in _bridge.tree_leaves(grads))
    assert sum(float(g.abs().sum()) for g in _bridge.tree_leaves(grads)) > 0.0
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=TOL["float32"])
    assert_grads(grads, jg, tcfg, "float32")


def test_label_masking():
    _, _, tm, tp = setup(VARIANTS["smoke"])
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 8), dtype=np.int32))
    loss, metrics = tm.loss(tp, {"tokens": toks, "labels": torch.full_like(toks, -1)})
    assert float(metrics["tokens"]) == 0.0
    assert float(loss) == 0.0


def test_remat_matches_no_remat():
    kw = {**VARIANTS["gqa"], "n_layers": 4}
    _, _, tm, tp = setup(kw)
    tm2 = TModel(dataclasses.replace(tm.cfg, remat=True), "cpu")
    batch = to_t(batch_np(4, 2, 8, 512))
    g1, m1 = make_grad_step(tm)(tp, batch)
    g2, m2 = make_grad_step(tm2)(tp, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    assert max(float((a - b).abs().max()) for a, b in
               zip(_bridge.tree_leaves(g1), _bridge.tree_leaves(g2))) < 1e-4


def test_train_step_updates_params_as_the_reference():
    from repro.launch.steps import make_train_step as jmake
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw

    jm, jp, tm, tp = setup(VARIANTS["gqa"])
    batch = batch_np(5, 2, 12, jm.cfg.vocab)
    jnew, _, jmet = jax.jit(jmake(jm, JAdamW(warmup_steps=2, total_steps=4)))(
        jp, jadamw.init(jp), to_j(batch))
    tnew, tst, tmet = make_train_step(tm, AdamWConfig(warmup_steps=2, total_steps=4))(
        tp, tadamw.init(tp), to_t(batch))
    assert int(tst.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    # AdamW's first step moves an element by lr·g/(|g| + eps), lr 1.5e-4 here:
    # where |g| is near eps = 1e-8, the step's size follows the grad's last bits.
    for a, b in zip(_bridge.tree_leaves(params_to_jax(tnew, tm.cfg)), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-5, rtol=1e-5)


# -- the kernels under autograd ------------------------------------------------


def _xw(seed, shape=(3, 5, 16)):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal(shape[-1:]).astype(np.float32) * 0.1).requires_grad_()
    return x, w


def test_kernel_function_takes_the_plain_vjp_exactly():
    # The plain version stands in for the kernel: the Function's output
    # carries its grad_fn, and its grads are autograd's of the plain version.
    x, w = _xw(0)
    y = kops.KernelWithPlainGrad.apply(kref.rmsnorm_ref, kref.rmsnorm_ref, {"eps": 1e-6}, x, w)
    assert type(y.grad_fn).__name__ == "KernelWithPlainGradBackward"
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, (x, w), dy)
    want = torch.autograd.grad(kref.rmsnorm_ref(x, w), (x, w), dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # only what requires grad gets one
    x2 = x.detach()
    y2 = kops.KernelWithPlainGrad.apply(kref.rmsnorm_ref, kref.rmsnorm_ref, {"eps": 1e-6}, x2, w)
    (gw,) = torch.autograd.grad(y2, (w,), dy)
    assert torch.equal(gw, torch.autograd.grad(kref.rmsnorm_ref(x2, w), (w,), dy)[0])


@pytest.mark.parametrize("hkv", [2, 4])
def test_flash_under_grad_takes_its_plain_vjp(hkv):
    rng = np.random.default_rng(hkv)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()

    q, k, v = t(2, 7, 4, 16), t(2, 7, hkv, 16), t(2, 7, hkv, 16)
    out = kops.flash_attention(q, k, v)  # model layout [B, L, H, d]
    assert type(out.grad_fn).__name__ == "KernelWithPlainGradBackward"
    dy = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), dy)
    want_out = kref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    want = torch.autograd.grad(want_out, (q, k, v), dy)
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_call_the_kernel_directly_without_grad_and_decode_raises_under_grad():
    x, w = _xw(2)
    with torch.no_grad():
        assert kops.rmsnorm(x, w).grad_fn is None
    assert kops.rmsnorm(x.detach(), w.detach()).grad_fn is None
    assert kops.rmsnorm(x, w).grad_fn is not None
    q = torch.zeros(2, 1, 4, 16, requires_grad=True)
    cache = torch.zeros(2, 8, 2, 16)
    with pytest.raises(RuntimeError, match="decode attention has no gradient"):
        kops.decode_attention(q, cache, cache, 3)
    with torch.inference_mode():
        assert kops.decode_attention(q, cache, cache, 3).shape == (2, 1, 4, 16)


def test_rmsnorm_plain_vjp_matches_jax_vjp():
    from repro.models.layers import rms_norm as jrms

    x, w = _xw(3, (4, 6, 32))
    dy = np.random.default_rng(4).standard_normal((4, 6, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jrms(a, b, 1e-6), jnp.asarray(x.detach().numpy()),
                     jnp.asarray(w.detach().numpy()))
    jx, jw = vjp(jnp.asarray(dy))
    y = kops.rmsnorm(x, w)
    tx, tw = torch.autograd.grad(y, (x, w), torch.from_numpy(dy))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=1e-4)


def test_kernel_path_under_remat_counts_its_launches_and_matches_the_plain_path(monkeypatch):
    """The card's training path, rehearsed on the CPU: layers take the kernel
    wrappers (which return their plain versions for CPU tensors, counted as
    the card's launches), under the Function and remat.  Each fwdbwd calls
    rmsnorm 2L + 1 times forward and 2L in the recompute, flash L and L,
    decode never."""
    kw = {**VARIANTS["gqa"], "remat": True}
    _, _, tm, tp = setup(kw)
    batch = to_t(batch_np(6, 2, 10, 512))
    plain_g, plain_m = make_grad_step(tm)(tp, batch)

    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    kops.reset_launch_counts()
    kern_g, kern_m = make_grad_step(tm)(tp, batch)
    n = tm.cfg.n_layers
    assert kops.launch_counts() == {"rmsnorm": (2 * n + 1) + 2 * n, "flash_attention": 2 * n}
    np.testing.assert_allclose(float(kern_m["loss"]), float(plain_m["loss"]), rtol=TOL["float32"])
    for name, a in _bridge.tree_flatten_with_path(kern_g):
        assert float(a.abs().max()) > 0.0, name  # every leaf has a gradient
    for a, b in zip(_bridge.tree_leaves(kern_g), _bridge.tree_leaves(plain_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_moe_kernel_path_under_remat_counts_its_launches_and_matches_the_plain_path(monkeypatch):
    """The same rehearsal on granite-moe's smoke config: the dense counts,
    2L + 1 + 2L and 2L, and the MoE slot kernel once a MoE FFN, forward and
    recompute."""
    _, _, tm, tp = moe_setup("granite-remat")
    batch = to_t(batch_np(8, 2, 10, tm.cfg.vocab))
    plain_g, plain_m = make_grad_step(tm)(tp, batch)
    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    kops.reset_launch_counts()
    kern_g, kern_m = make_grad_step(tm)(tp, batch)
    n = tm.cfg.n_layers
    n_moe = sum(f == "moe" for _, f in tm.cfg.layer_seq())
    assert n_moe > 0
    assert kops.launch_counts() == {"rmsnorm": (2 * n + 1) + 2 * n, "flash_attention": 2 * n, "moe_slots": 2 * n_moe}
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(kern_m[k]), float(plain_m[k]), rtol=TOL["float32"])
    for name, a in _bridge.tree_flatten_with_path(kern_g):
        assert float(a.abs().max()) > 0.0, name
    for a, b in zip(_bridge.tree_leaves(kern_g), _bridge.tree_leaves(plain_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_jamba_kernel_path_counts_its_launches_and_matches_the_plain_path(monkeypatch):
    """Jamba's smoke config (one 8-layer period: 7 mamba, 1 attention, 4 MoE
    and 4 MLP FFNs) on the kernel path, rehearsed on the CPU: a forward, a
    prefill and a decode step each call rmsnorm 8 + 8 + 1 = 17 times; flash
    once in a forward or prefill, decode once a step; the MoE slot kernel
    once a MoE FFN; the mixers call none.  A remat fwdbwd adds the
    recompute's 16 norms, 1 flash and 4 slot calls."""
    jm, jp, tm, tp = rec_setup("jamba-smoke", True)
    toks = torch.from_numpy(batch_np(11, 2, 10, 512)["tokens"])
    batch = to_t(batch_np(11, 2, 10, 512))
    plain_logits = tm.forward(tp, toks)
    plain_g, plain_m = make_grad_step(tm)(tp, batch)
    cache = tm.init_cache(2, 12)
    plain_pre, cache = tm.prefill(tp, toks[:, :9], cache)
    plain_dec, _ = tm.decode_step(tp, toks[:, 9:], cache)

    monkeypatch.setattr(kops, "use_kernel", lambda x: True)

    def counted(fn, *args):
        kops.reset_launch_counts()
        out = fn(*args)
        return out, kops.launch_counts()

    with torch.no_grad():
        logits, n_fwd = counted(tm.forward, tp, toks)
        (pre, cache), n_pre = counted(tm.prefill, tp, toks[:, :9], tm.init_cache(2, 12))
        (dec, _), n_dec = counted(tm.decode_step, tp, toks[:, 9:], cache)
    assert n_fwd == {"rmsnorm": 17, "flash_attention": 1, "moe_slots": 4}
    assert n_pre == {"rmsnorm": 17, "flash_attention": 1, "moe_slots": 4}
    assert n_dec == {"rmsnorm": 17, "decode_attention": 1, "moe_slots": 4}
    for got, want in ((logits, plain_logits), (pre, plain_pre), (dec, plain_dec)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-4)
    (kern_g, kern_m), n_bwd = counted(make_grad_step(tm), tp, batch)
    assert n_bwd == {"rmsnorm": 17 + 16, "flash_attention": 2, "moe_slots": 4 + 4}
    np.testing.assert_allclose(float(kern_m["loss"]), float(plain_m["loss"]), rtol=TOL["float32"])
    for a, b in zip(_bridge.tree_leaves(kern_g), _bridge.tree_leaves(plain_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch,pods", [("xlstm-125m", 2), ("gemma2-27b", 1)])
def test_trainer_on_the_kernel_path_launches_as_phase_13_expects(arch, pods, monkeypatch):
    """Phase 13 of ``chip_smoke.py`` rehearsed on the CPU: the arch's smoke
    config in bf16 with remat (gemma2 at 24 tokens, past its window of 16)
    through ``Trainer`` with the switch forced to the kernel path, whose
    wrappers take their plain versions on the CPU and count each call as the
    card's launch.  At 2 pods both ``fwdbwd`` steps must be in flight at
    once (a barrier that both must reach).  From counts of 0, one
    iteration's ``ops.launch_counts()`` must equal ``chip_smoke.train_launches``
    exactly; every leaf changes and keeps its dtype, the fp32 ones included."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(tget(arch, smoke=True), dtype="bfloat16", remat=True)
    tr = Trainer(cfg, steps=2, n_pods=pods, global_batch=4, seq_len=24, ckpt_dir=None, device="cpu")
    together = threading.Barrier(pods, timeout=60)
    step_fns = tr.step_fns

    def concurrent_fns():
        fns = step_fns()
        for i in range(pods):
            def fwdbwd(inputs, inner=fns[f"fwdbwd_{i}"]):
                together.wait()  # breaks, and the step fails, unless every pod's fwdbwd runs at once
                return inner(inputs)
            fns[f"fwdbwd_{i}"] = fwdbwd
        return fns

    monkeypatch.setattr(tr, "step_fns", concurrent_fns)
    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    p0 = tr.params
    kops.reset_launch_counts()
    m = tr.iteration(0)
    assert kops.launch_counts() == cs.train_launches(cfg, pods)
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    fp32 = [n for n, t in _bridge.tree_flatten_with_path(p0) if t.dtype == torch.float32]
    assert fp32 == [n for n, _ in _bridge.tree_flatten_with_path(p0) if cs.FP32_LEAF.search(n)]
    assert bool(fp32) == (arch == "xlstm-125m")
    for (name, a), b in zip(_bridge.tree_flatten_with_path(p0), _bridge.tree_leaves(tr.params)):
        assert a.dtype == b.dtype, name
        assert not torch.equal(a, b), name


def test_mixer_backward_check_of_phase_13_runs_and_sees_a_planted_fault():
    """``chip_smoke.mixers_backward_card_vs_cpu`` rehearsed with the CPU on
    both sides, at the smoke configs' widths in fp32: every grad agrees, and
    a planted fault (each mixer's input rounded to bf16 on the checked side,
    as TF32 rounds a matmul's on the card) reads beyond fp32 TOL; with
    nothing planted, the check fails."""
    from repro_torch.models import recurrent

    cs = _chip_smoke()
    cfgs = {mixer: dataclasses.replace(tget(arch, smoke=True), dtype="float32")
            for mixer, arch in (("mamba", "jamba-v0.1-52b"), ("mlstm", "xlstm-125m"), ("slstm", "xlstm-125m"))}

    @contextlib.contextmanager
    def rounded_inputs():
        with pytest.MonkeyPatch.context() as mp:
            for mixer in cfgs:
                mix = getattr(recurrent, f"{mixer}_mix")
                mp.setattr(recurrent, f"{mixer}_mix",
                           lambda cfg, p, x, state=None, mix=mix: mix(cfg, p, x.bfloat16().float(), state))
            yield

    out = cs.mixers_backward_card_vs_cpu(torch, "CPU rehearsal", device="cpu", cfgs=cfgs, plant=rounded_inputs)
    assert sorted(out) == sorted(cfgs)
    for mixer, r in out.items():
        assert len(r["rel_l2"]) > 3 and max(r["rel_l2"].values()) <= 2e-5, mixer
        assert r["planted_rel_l2"] > 2e-5, mixer
    with pytest.raises(SystemExit, match="cannot tell the planted fault"):
        cs.mixers_backward_card_vs_cpu(torch, "CPU rehearsal", device="cpu", cfgs=cfgs, plant=contextlib.nullcontext)


def test_launch_counters_add_under_their_locks():
    """One lock guards every kernel's count, so that two pods' threads cannot
    lose a count between the read and the write of a bare ``+= 1``: while
    the lock is held, a thread's add waits and adds nothing; released, it
    adds its one.  And 4 threads adding 20,000 to every kernel's count,
    switching every microsecond, add 80,000 to each."""
    from repro_torch.kernels import _build

    for name in _build.KERNELS:
        kops.reset_launch_counts()
        with _build.launch_lock:
            t = threading.Thread(target=kops.add_launch_counts, args=({name: 1},))
            t.start()
            t.join(0.2)
            assert t.is_alive() and _build.launches[name] == 0, name
        t.join(10)
        assert not t.is_alive() and kops.launch_counts() == {name: 1}, name

    def add():
        for _ in range(20_000):
            for name in _build.KERNELS:
                _build.count(name)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kops.reset_launch_counts()
        threads = [threading.Thread(target=add) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert kops.launch_counts() == dict.fromkeys(_build.KERNELS, 80_000)
    kops.reset_launch_counts()
    assert kops.launch_counts() == {}


def test_moe_trainer_keeps_the_fp32_router_in_a_bf16_model():
    """One iteration of granite-moe's smoke config in bf16, 2 pods, int8
    gradsync: AdamW and the compression keep each leaf's own dtype (the
    router fp32, the experts bf16, the moments fp32), aux > 0, every leaf moves."""
    cfg = dataclasses.replace(tget("granite-moe-1b-a400m", smoke=True), dtype="bfloat16")
    tr = Trainer(cfg, steps=2, n_pods=2, global_batch=4, seq_len=16, ckpt_dir=None, device="cpu")
    p0 = tr.params
    m = tr.iteration(0)
    assert np.isfinite(m["loss"]) and m["aux"] > 0.0
    for (name, a), b in zip(_bridge.tree_flatten_with_path(p0), _bridge.tree_leaves(tr.params)):
        want = torch.float32 if name.endswith("router/w") else torch.bfloat16
        assert a.dtype == b.dtype == want, name
        assert not torch.equal(a, b), name
    for leaf in _bridge.tree_leaves((tr.opt_state.m, tr.opt_state.v)):
        assert leaf.dtype == torch.float32


# -- the trainer: the port's own integration cases -----------------------------


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = ttrain(ARCH, steps=8, ckpt_dir=str(d), device="cpu", **RUN)
    return d, out


def test_loss_decreases(short_run):
    _, out = short_run
    losses = [float(h["loss"]) for h in out["history"]]
    assert min(losses[3:]) < losses[0]


def test_checkpoint_written_and_resumes(short_run, tmp_path):
    d, out = short_run
    assert latest_step(d) == 8
    shutil.copytree(d, tmp_path / "c")
    out2 = ttrain(ARCH, steps=2, ckpt_dir=str(tmp_path / "c"), device="cpu", **RUN)
    assert len(out2["history"]) == 2
    assert int(out2["opt"].step) == 10 and latest_step(tmp_path / "c") == 10


def test_pods_agree_with_single_pod():
    run = {**RUN, "n_pods": 1}
    a = ttrain(ARCH, steps=3, ckpt_dir=None, compress_grads=False, device="cpu", **run)
    b = ttrain(ARCH, steps=3, ckpt_dir=None, compress_grads=False, device="cpu", **RUN)
    diffs = [float((x - y).abs().max()) for x, y in
             zip(_bridge.tree_leaves(a["params"]), _bridge.tree_leaves(b["params"]))]
    assert max(diffs) < 1e-5


def test_compressed_training_tracks_uncompressed():
    a = ttrain(ARCH, steps=6, ckpt_dir=None, compress_grads=False, device="cpu", **RUN)
    b = ttrain(ARCH, steps=6, ckpt_dir=None, compress_grads=True, device="cpu", **RUN)
    la, lb = float(a["history"][-1]["loss"]), float(b["history"][-1]["loss"])
    assert abs(la - lb) / la < 0.05


def test_an_iteration_passes_the_trees_by_reference():
    # The inprocess backend places nothing: the params and optimizer trees
    # (dicts, a NamedTuple) and the numpy batch (a dict) reach the steps as
    # the very objects given, so no iteration copies the model.
    tr = Trainer(tget(ARCH, smoke=True), steps=1, n_pods=2, global_batch=4, seq_len=8,
                 ckpt_dir=None, device="cpu")
    fns, seen = tr.step_fns(), {}
    for name in ("fwdbwd_1", "update_0"):
        def spy(inputs, name=name, inner=fns[name]):
            seen[name] = inputs
            return inner(inputs)
        fns[name] = spy
    payloads = {}
    for i in range(2):
        payloads[(f"pod{i}", f"iter_{i}")] = 0
        payloads[(f"pod{i}", f"params_{i}")] = tr.params
        payloads[(f"pod{i}", f"opt_{i}")] = tr.opt_state
    res = tr.lowered.compile(fns).run(initial_payloads=payloads)
    assert seen["fwdbwd_1"]["params_1"] is tr.params
    assert seen["update_0"]["opt_0"] is tr.opt_state
    assert isinstance(seen["fwdbwd_1"]["batch_1"]["tokens"], np.ndarray)
    # Lowered as the reference trainer lowers: inprocess, RetryPolicy(max_retries=2).
    assert (tr.lowered.backend_name, tr.lowered.options) == ("inprocess", {"retry": RetryPolicy(max_retries=2)})
    assert res.backend == "inprocess"
    # 2 shards, 2 fwdbwds, gradsync, 2 updates; the plan's 4 comm actions fire
    # as 2 send/recv pairs (the reference's inprocess run reports 7 and 2 too).
    st = res.stats
    assert (st.execs, st.comms, st.retries, st.timeouts, st.speculations) == (7, 2, 0, 0, 0)
    assert sorted(step for step, _, _ in st.exec_log) == sorted(set(fns) - {"ckpt"})  # no ckpt_dir


# -- the slice as a whole: resume both packages from one reference checkpoint ---


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_ckpt")
    jtrain(ARCH, steps=3, ckpt_dir=str(d / "base"), **RUN)
    return d


@pytest.mark.parametrize("compress", [False, True])
def test_port_resumes_a_reference_checkpoint_as_the_reference_does(reference_checkpoint, compress):
    d = reference_checkpoint
    jd, td = d / f"j{compress}", d / f"t{compress}"
    shutil.copytree(d / "base", jd)
    shutil.copytree(d / "base", td)
    a = jtrain(ARCH, steps=2, ckpt_dir=str(jd), compress_grads=compress, **RUN)
    b = ttrain(ARCH, steps=2, ckpt_dir=str(td), compress_grads=compress, device="cpu", **RUN)
    assert len(a["history"]) == len(b["history"]) == 2
    for ha, hb in zip(a["history"], b["history"]):
        assert sorted(ha) == sorted(hb)
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(hb[k], ha[k], rtol=TOL["float32"], err_msg=k)
        assert hb["tokens"] == ha["tokens"]
    tol = 1e-4 if compress else 1e-5
    cfg = tget(ARCH, smoke=True)
    for a_, b_ in zip(_bridge.tree_leaves(params_to_jax(b["params"], cfg)), jax.tree.leaves(a["params"])):
        assert float(np.max(np.abs(f32(a_) - f32(b_)))) < tol
    # both wrote step 5 with the same leaves, shapes and dtypes
    import json

    mj = json.loads((jd / "step_000000005" / "manifest.json").read_text())
    mt = json.loads((td / "step_000000005" / "manifest.json").read_text())
    assert mt == mj


# -- the entry point -------------------------------------------------------------


def test_cli_trains_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu", "--smoke", "--steps", "2", "--pods", "2"])
    tmain()
    out = capsys.readouterr().out
    assert "[swirl] plan: 12 actions, 4 comms" in out and "[done] 2 steps" in out


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain(ARCH, steps=1, ckpt_dir=None, **RUN)
