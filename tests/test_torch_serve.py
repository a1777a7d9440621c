"""The port's serving path against ``repro.launch.serve``'s steps (CPU).

Same config (llama3.2-3b smoke, fp32; the granite-moe and deepseek-moe
smoke configs; the xlstm-125m and jamba-v0.1-52b smoke configs; the gemma2,
nemotron, qwen, internvl2 and seamless smoke configs, with the same
numpy-made frame or patch embeddings on both sides), the same weights (the reference's
init, converted) and the same prompts (``jax.random.randint(key(seed+1))``,
as ``repro.launch.serve.serve`` draws them): the greedy tokens must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import Model as JModel
from repro_torch._bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import generate, serve
from repro_torch.models import Model as TModel
from repro_torch.models import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tensors here are tiny: torch's CPU thread pool costs more than it
    # saves (over 100x on a shared machine), so run them on one thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tokens(jm, params, prompts, gen, frontend=None):
    """repro.launch.serve.serve's loop, on the given params, prompts and
    frontend inputs; its cache counts a vision model's patches."""
    prefill = jax.jit(make_prefill_step(jm))
    step = jax.jit(make_serve_step(jm))
    cfg = jm.cfg
    max_len = prompts.shape[1] + gen + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    cache = jm.init_cache(prompts.shape[0], max_len)
    next_tok, cache = prefill(params, {"tokens": prompts, **(frontend or {})}, cache)
    out = [np.asarray(next_tok)[:, None]]
    tok = next_tok[:, None]
    for _ in range(gen - 1):
        tok, cache = step(params, cache, tok)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("seed,batch,prompt_len,gen", [(0, 4, 32, 16), (3, 2, 7, 5)])
def test_greedy_tokens_match_reference(seed, batch, prompt_len, gen):
    jcfg, tcfg = jget("llama3.2-3b", smoke=True), tget("llama3.2-3b", smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    prompts = jax.random.randint(
        jax.random.key(seed + 1), (batch, prompt_len), 0, jcfg.vocab
    ).astype(jnp.int32)
    want = _reference_tokens(jm, jp, prompts, gen)

    tm = TModel(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    res = generate(tm, tp, to_torch(prompts), gen)
    assert res["tokens"].dtype == np.int32
    np.testing.assert_array_equal(res["tokens"], want)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_greedy_tokens_match_reference(arch):
    # The MoE smoke configs (fp32): prefill routes T = 4 x 12 tokens at the
    # smoke capacity factor, which drops choices; each decode step routes 4.
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = jax.random.randint(jax.random.key(1), (4, 12), 0, jcfg.vocab).astype(jnp.int32)
    want = _reference_tokens(jm, jp, prompts, 8)
    tm = TModel(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    np.testing.assert_array_equal(generate(tm, tp, to_torch(prompts), 8)["tokens"], want)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_serve_on_cpu(arch):
    res = serve(arch, smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_recurrent_greedy_tokens_match_reference(arch):
    # fp32 smoke configs: xlstm's mLSTM + sLSTM, and jamba's 7 mamba layers,
    # one attention layer without RoPE and 4 MoE FFNs (whose prefill at
    # T = 4 x 12 drops choices at the smoke capacity factor).
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = jax.random.randint(jax.random.key(1), (4, 12), 0, jcfg.vocab).astype(jnp.int32)
    want = _reference_tokens(jm, jp, prompts, 8)
    tm = TModel(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    np.testing.assert_array_equal(generate(tm, tp, to_torch(prompts), 8)["tokens"], want)


FAMILY_ARCHS = ["gemma2-27b", "nemotron-4-15b", "qwen1.5-110b", "internvl2-1b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_greedy_tokens_match_reference(arch):
    # gemma2's 30-token prompt and 8 steps run past its smoke window of 16.
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = jax.random.randint(jax.random.key(1), (4, 30), 0, jcfg.vocab).astype(jnp.int32)
    rng = np.random.default_rng(2)
    shape = (4, jcfg.frontend_len, jcfg.d_model)
    fe = {}
    if jcfg.is_encoder_decoder:
        fe["src_embeds"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if jcfg.frontend == "vision":
        fe["patch_embeds"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    want = _reference_tokens(jm, jp, prompts, 8, {k: jnp.asarray(v) for k, v in fe.items()})
    tm = TModel(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    got = generate(tm, tp, to_torch(prompts), 8, {k: torch.from_numpy(v) for k, v in fe.items()})
    np.testing.assert_array_equal(got["tokens"], want)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_serve_on_cpu(arch):
    res = serve(arch, smoke=True, batch=2, prompt_len=20, gen=4, device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()


def test_make_frontend_draws_as_the_reference_serve():
    # src_embeds from seed + 2, patch_embeds from seed + 3, N(0, 1) * 0.1 of
    # [batch, frontend_len, d_model] in the config's dtype; none for a text model.
    from repro_torch.launch.serve import make_frontend

    for arch, name, offset in (("seamless-m4t-medium", "src_embeds", 2), ("internvl2-1b", "patch_embeds", 3)):
        cfg = tget(arch)
        fe = make_frontend(cfg, 2, 5, "cpu")
        assert list(fe) == [name]
        t = fe[name]
        assert t.shape == (2, cfg.frontend_len, cfg.d_model) and t.dtype == torch.bfloat16
        g = torch.Generator().manual_seed(5 + offset)
        want = (torch.randn(t.shape, generator=g) * 0.1).to(torch.bfloat16)
        assert torch.equal(t, want)
    assert make_frontend(tget("llama3.2-3b"), 2, 5, "cpu") == {}


def test_cli_serves_the_reference_default_arch_on_cpu(monkeypatch, capsys):
    # As the reference's CLI: no --arch serves xlstm-125m (its smoke config).
    import sys

    from repro_torch.launch.serve import main

    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                                      "--gen", "3"])
    main()
    out = capsys.readouterr().out
    assert "arch=xlstm-125m-smoke device=cpu batch=2 prefill=6 gen=3" in out
    res = serve("xlstm-125m", smoke=True, batch=2, prompt_len=6, gen=3, device="cpu")
    assert res["tokens"].shape == (2, 3) and ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()


def test_serve_cuts_the_depth(monkeypatch):
    # n_layers (--layers) replaces the config's depth: jamba's smoke config is
    # one 8-layer period, so 16 is two periods and 3 is not a whole number.
    import repro_torch.launch.serve as tserve

    made = []
    monkeypatch.setattr(tserve, "Model", lambda cfg, dev: made.append(cfg) or TModel(cfg, dev))
    res = serve("jamba-v0.1-52b", smoke=True, batch=2, prompt_len=6, gen=3, device="cpu", n_layers=16)
    assert res["tokens"].shape == (2, 3) and made[0].n_layers == 16 and len(made[0].layer_seq()) == 16
    with pytest.raises(ValueError, match="not divisible"):
        serve("jamba-v0.1-52b", smoke=True, batch=2, prompt_len=6, gen=3, device="cpu", n_layers=3)


def test_serve_on_cpu_returns_reference_dict():
    res = serve("llama3.2-3b", smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert set(res) == {"tokens", "prefill_s", "decode_s", "tok_per_s"}
    assert res["tokens"].shape == (2, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()
