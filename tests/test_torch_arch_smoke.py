"""``tests/test_arch_smoke.py`` on the port: each of the ten archs' smoke
config (CPU, plain path) runs a forward, a loss and its gradients, and a
prefill with 3 decode steps, with the shapes the reference gives and nothing
non-finite; and each full config is the assignment's row and the reference's
config field for field.  Inputs are drawn from seeded torch generators, as the
reference's test draws its own from ``jax.random`` keys."""

import dataclasses

import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro_torch._bridge import tree_leaves
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.steps import make_grad_step
from repro_torch.models import Model, padded_vocab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, b, l, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, l), generator=g, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    dtype = getattr(torch, cfg.dtype)
    shape = (b, cfg.frontend_len, cfg.d_model)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = (torch.randn(shape, generator=g) * 0.1).to(dtype)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (torch.randn(shape, generator=g) * 0.1).to(dtype)
    return batch


def _frontend(batch):
    return {k: v for k, v in batch.items() if k in ("src_embeds", "patch_embeds")}


def test_the_port_registers_the_reference_archs():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_forward_and_train(arch):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b, l = 2, 16
    batch = _batch(cfg, b, l)

    with torch.no_grad():
        logits = model.forward(params, batch["tokens"], **_frontend(batch))
    exp_len = l + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    assert logits.shape == (b, exp_len, padded_vocab(cfg))
    assert bool(logits.float().isfinite().all())

    grads, metrics = make_grad_step(model)(params, batch)
    assert bool(metrics["loss"].isfinite()), arch
    assert all(bool(g.float().isfinite().all()) for g in tree_leaves(grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_decode(arch):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b = 2
    batch = _batch(cfg, b, 8)
    cache = model.init_cache(b, 32 + (cfg.frontend_len if cfg.frontend == "vision" else 0))
    with torch.no_grad():
        logits, cache = model.prefill(params, batch["tokens"], cache, **_frontend(batch))
        assert logits.shape[0] == b
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        for _ in range(3):
            logits, cache = model.decode_step(params, tok, cache)
            assert bool(logits.float().isfinite().all()), arch
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)


ASSIGNMENT = {  # (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab), as tests/test_arch_smoke.py
    "seamless-m4t-medium": (12, 1024, 16, 16, 4096, 256206),
    "gemma2-27b": (46, 4608, 32, 16, 36864, 256000),
    "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000),
    "llama3.2-3b": (28, 3072, 24, 8, 8192, 128256),
    "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
    "xlstm-125m": (12, 768, 4, 4, 0, 50304),
    "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
    "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
    "deepseek-moe-16b": (28, 2048, 16, 16, 10944, 102400),
    "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_config_exactness(arch):
    """The registered full config matches the assignment row and the reference's config."""
    cfg = get_config(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab)
    assert got == ASSIGNMENT[arch]
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == dataclasses.asdict(jget(arch, smoke=smoke))
