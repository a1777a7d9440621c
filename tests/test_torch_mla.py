"""The port's multi-head latent attention (``models/mla.py``) and its
DeepSeek-V2-Lite config against the benchmark's plain reference
(``bench/reference/mla_decoder.py``), on the CPU at a tiny size in fp32, with
weights drawn by the benchmark's own ``weights.make_params``: prefill then
decode through the latent cache equals the reference's full forward; the
absorbed decode equals the expanded attention; YaRN's frequencies and the
softmax scale are the published ones; the benchmark's layer kind, FLOPs and
the graph's eligibility agree with the port."""

import dataclasses
import math

import pytest
import torch

from bench import layers
from bench.counts import flops
from bench.harness import weights
from bench.reference import mla_decoder
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch.steps import _addresses, abstract_params, make_prefill_step, make_serve_step, why_eager
from repro_torch.models import MLACfg, Model, MoECfg
from repro_torch.models import mla

# A tiny MLA + MoE model: a dense layer 0, then 2 MoE layers of 8 experts top-2 and 1 shared.
TINY = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512)
TINY_MOE = dict(n_experts=8, top_k=2, d_expert=32, n_shared=1, capacity_factor=1.25, router_aux_weight=0.01)
TINY_MLA = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                mscale_all_dim=0.707)
# The logits of 4 sequences after prefill and decode, fp32 on both sides, are
# one reduction order apart: they read 1.0e-6 of the logits' largest magnitude.
# 2e-5 leaves room for that; a latent cache rounded to bf16 (2^-9 relative on
# each cached value) reads 0.2, as a rounded score also flips a routing choice
# (the control below).
LOGIT_TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(dtype="float32"):
    full = get_config("deepseek-v2-lite")
    return dataclasses.replace(full, name="mla-tiny", **TINY, moe=MoECfg(**TINY_MOE), mla=MLACfg(**TINY_MLA),
                               dtype=dtype, remat=False)


def tiny_m(dtype="float32") -> dict:
    """The benchmark's ``model`` section of :func:`tiny_cfg`, with its numerics."""
    return {**TINY, "prefix_pattern": [["mla", "dense0"]], "pattern": [["mla", "moe"]], "moe": dict(TINY_MOE),
            "mla": dict(TINY_MLA), "rope_theta": 10000.0, "tied_embeddings": False, "dtype": dtype,
            "norm_eps": 1e-6}


def full_m() -> dict:
    import json

    from bench.harness.core import ROOT

    conf = json.loads((ROOT / "bench" / "configs" / "deepseek-v2-lite.json").read_text())
    return {**conf["model"], **conf["numerics"]}


def serve_on_the_port(cfg, params, prompts, gen):
    """Prefill then ``gen - 1`` decode steps through the cache, greedy:
    ``(served [B, gen], logits [B, gen, vocab])``."""
    model = Model(cfg, "cpu")
    b, l0 = prompts.shape
    cache = model.init_cache(b, l0 + gen)
    toks, outs = [], []
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts, cache)
        for j in range(gen):
            outs.append(logits[:, -1, : cfg.vocab].float())
            toks.append(logits[:, -1].argmax(-1).to(torch.int32))
            if j + 1 < gen:
                logits, cache = model.decode_step(params, toks[-1][:, None], cache)
    return torch.stack(toks, 1), torch.stack(outs, 1)


def gap_of_the_port(round_cache=None, monkeypatch=None):
    m, cfg = tiny_m(), tiny_cfg()
    params = weights.make_params(m, 20260501, "cpu")
    prompts = torch.randint(0, m["vocab"], (4, 11), generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    if round_cache is not None:
        monkeypatch.setattr(mla, "_cache_write", round_cache)
    served, got = serve_on_the_port(cfg, params, prompts, 6)
    want = mla_decoder.serve_logits(m, lambda g: weights.make_group(m, g, 20260501, "cpu"), prompts, served)[0]
    return float((got - want).abs().max() / want.abs().max())


def test_prefill_and_decode_through_the_latent_cache_equal_the_references_full_forward():
    assert gap_of_the_port() < LOGIT_TOL


def test_a_latent_cache_rounded_to_bf16_reads_beyond_the_tolerance(monkeypatch):
    """The control: the same run with every cached ``c_kv`` and ``k_pe`` row
    rounded to bf16 as it is written fails the tolerance above."""
    write = mla._cache_write

    def rounded(buf, rows, new):
        return write(buf, rows, new.bfloat16().float())

    assert gap_of_the_port(rounded, monkeypatch) > 5 * LOGIT_TOL


def test_the_absorbed_decode_equals_the_expanded_attention():
    cfg = tiny_cfg()
    a, h = cfg.mla, cfg.n_heads
    g = torch.Generator().manual_seed(3)
    p = Model(cfg, "cpu").init(g)["layers"][0]["mixer"]
    b, rows, kv = 3, 20, 17
    q_nope = torch.randn(b, h, a.qk_nope_head_dim, generator=g)
    q_pe = torch.randn(b, h, a.qk_rope_head_dim, generator=g)
    c_kv = torch.randn(b, rows, a.kv_lora_rank, generator=g)
    k_pe = torch.randn(b, rows, a.qk_rope_head_dim, generator=g)
    kv_len = torch.tensor(kv, dtype=torch.int32)
    absorbed = mla._absorbed(cfg, p, q_nope, q_pe, c_kv, k_pe, kv_len)
    qs = torch.cat([q_nope, q_pe], -1)[:, None] * mla.yarn_mscale(a.factor, a.mscale_all_dim) ** 2
    expanded = mla._expanded(cfg, p, qs, c_kv, k_pe, kv - 1, kv_len)[:, 0]
    # fp32 both ways; the products associate differently: ~1e-7 of the values
    torch.testing.assert_close(absorbed, expanded, rtol=1e-5, atol=1e-5)


def test_yarn_and_the_softmax_scale_are_the_published_ones():
    cfg = get_config("deepseek-v2-lite")
    a = cfg.mla
    assert mla.yarn_correction_range(a, cfg.rope_theta) == (10, 23)
    # DeepseekV2YarnRotaryEmbedding, in float64: extrapolated below index 10, divided by 40 above 23.
    i = torch.arange(32, dtype=torch.float64)
    extra = 1.0 / 10000.0 ** (2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    published = extra / 40 * ramp + extra * (1 - ramp)
    got = mla.yarn_inv_freq_cpu(a, cfg.rope_theta).double()
    # computed in fp32 as the published module does: one fp32 rounding apart
    torch.testing.assert_close(got, published, rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:10], extra[:10], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[24:], extra[24:] / 40, rtol=1e-6, atol=0)
    ref_inv = mla_decoder.yarn_inv_freq(full_m()["mla"], 10000.0, "cpu")
    assert torch.equal(got.float(), ref_inv)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.2608) < 1e-4
    assert mla.softmax_scale(cfg) == pytest.approx(192**-0.5 * m**2, rel=1e-12)
    assert mla.softmax_scale(cfg) == pytest.approx(0.11472, abs=5e-6)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_the_benchmarks_layer_kind_is_the_ports_layout(which):
    m, cfg = (tiny_m(), tiny_cfg()) if which == "tiny" else (full_m(), get_config("deepseek-v2-lite"))
    params = abstract_params(Model(cfg, "cpu"))  # meta tensors: nothing allocated at full width
    kind = layers.load("mla")
    for i, (mixer, _) in enumerate(cfg.layer_seq()):
        assert mixer == "mla"
        got = [(path, tuple(t.shape)) for path, t in weights.flatten(params["layers"][i]["mixer"])]
        want = sorted(("/".join(path), shape) for path, shape, _, _ in kind.leaves(m))
        assert got == want
    assert kind.macs(m) == cfg._mixer_params("mla") - cfg.mla.kv_lora_rank  # all but the latent's norm
    assert [lf[:2] for lf in weights.group_leaves(m, 1)] == [
        (("norm1", "w"), (m["d_model"],)), *((("mixer", *p), s) for p, s, _, _ in kind.leaves(m)),
        (("norm2", "w"), (m["d_model"],)), *((("ffn", *p), s) for p, s, _, _ in layers.load("dense0").leaves(m))]


def test_the_model_flops_of_the_cell_are_pinned():
    m = full_m()
    assert layers.load("mla").macs(m) == 13_762_560 and layers.load("mla").key_flops(m) == 10_240
    assert flops.prefill(m, 4, 32000) == 1_140_098_308_505_600
    assert flops.decode_step(m, 4, 32100) == 55_110_500_352


def test_the_arch_is_the_ports_own_and_has_the_published_widths():
    cfg = get_config("deepseek-v2-lite")
    assert "deepseek-v2-lite" in PORT_ARCHS and "deepseek-v2-lite" not in ARCHS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.d_ff) == (27, 2048, 16, 102400, 10944)
    assert cfg.mla == MLACfg() and (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert, cfg.moe.n_shared) == (
        64, 6, 1408, 2)
    assert cfg.layer_seq() == (("mla", "dense0"),) + (("mla", "moe"),) * 26
    assert round(cfg.param_count() / 1e9, 1) == 15.7
    smoke = get_config("deepseek-v2-lite", smoke=True)
    assert smoke.mla.kv_lora_rank == 32 and smoke.d_model == 64


def test_why_eager_takes_the_latent_cache_and_on_the_cpu_names_only_the_device():
    cfg = tiny_cfg()
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16)
    assert [sorted(e) for e in cache["layers"]] == [["c_kv", "k_pe"]] * cfg.n_layers
    token = torch.zeros((2, 1), dtype=torch.int32)
    with torch.inference_mode():
        assert why_eager(params, cache, token) == "the token or the cache is not on a CUDA device"
    addresses = _addresses(cache)
    assert addresses is not None and len(addresses) == 2 * cfg.n_layers
    # c_kv and k_pe are views of one buffer: a cache row is [c_kv, k_pe].
    e = cache["layers"][0]
    assert e["k_pe"].data_ptr() == e["c_kv"].data_ptr() + cfg.mla.kv_lora_rank * e["c_kv"].element_size()


def test_the_steps_serve_it_with_no_special_case():
    cfg = dataclasses.replace(tiny_cfg(), moe=MoECfg(**{**TINY_MOE, "capacity_factor": 8.0}))
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    prompts = torch.randint(0, cfg.vocab, (2, 7), generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    cache = model.init_cache(2, 12)
    step = make_serve_step(model)
    with torch.inference_mode():
        tok, cache = make_prefill_step(model)(params, {"tokens": prompts}, cache)
        toks = [tok]
        tok = tok[:, None]
        for _ in range(4):
            tok, cache = step(params, cache, tok)
            toks.append(tok[:, 0])
        full = model.forward(params, torch.cat([prompts, torch.stack(toks[:-1], 1)], 1))
    assert torch.equal(torch.stack(toks, 1), full[:, 6:, : cfg.vocab].argmax(-1).to(torch.int32))
    assert int(cache["len"]) == 11 and step.captures == 0


def test_the_kernel_path_launches_one_mla_decode_a_layer_and_step(monkeypatch):
    """On the CPU with the switch forced to the kernel path (bf16, as the
    absorbed kernel takes), each decode step calls the absorbed kernel's
    wrapper once a layer, and the counter counts it; no step calls flash or
    decode attention."""
    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    cfg = tiny_cfg("bfloat16")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 10)
    with torch.inference_mode():
        _, cache = model.prefill(params, torch.zeros((2, 5), dtype=torch.int32), cache)
        kops.reset_launch_counts()
        for _ in range(2):
            _, cache = model.decode_step(params, torch.zeros((2, 1), dtype=torch.int32), cache)
    counts = kops.launch_counts()
    assert counts.pop("mla_decode") == 2 * cfg.n_layers
    assert set(counts) == {"rmsnorm", "moe_slots"}, counts
    kops.reset_launch_counts()


def test_the_kernel_path_launches_as_chip_smoke_expects(monkeypatch):
    """Phase 19's rehearsal: with the switch forced to the kernel path, a
    prefill and a decode step call each kernel wrapper exactly as
    ``chip_smoke.serve_launches`` counts for the card (flash and one more
    rmsnorm an MLA layer in the prefill, one MLA decode a layer in the step),
    and give the plain path's logits."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(tiny_cfg(), moe=MoECfg(**{**TINY_MOE, "capacity_factor": 8.0}))
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    counts = []

    def run():
        cache = model.init_cache(2, 10)
        kops.reset_launch_counts()
        pre, cache = model.prefill(params, toks[:, :9], cache)
        counts.append(kops.launch_counts())
        kops.reset_launch_counts()
        dec, _ = model.decode_step(params, toks[:, 9:], cache)
        counts.append(kops.launch_counts())
        return pre, dec

    with torch.inference_mode():
        plain = run()
        counts.clear()
        monkeypatch.setattr(kops, "use_kernel", lambda x: True)
        kern = run()
    assert tuple(counts) == smoke.serve_launches(cfg), (counts, smoke.serve_launches(cfg))
    assert counts[1]["mla_decode"] == cfg.n_layers and "mla_decode" not in counts[0]
    for got, want in zip(kern, plain):
        # fp32 on both sides; the kernels' plain versions differ from the plain
        # path's ops in summation order only (~1e-6 of the logits).
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_an_fp32_decode_on_the_card_raises_and_does_not_fall_back_to_the_plain_version(monkeypatch):
    """Under the kernel switch the absorbed decode hands every dtype to the
    kernel's wrapper, which takes bf16 alone: fp32 CUDA tensors raise there
    and are not computed by the plain version.  Fake CUDA tensors stand in
    for the card's (they take the wrapper's checks, not the mixer's strided
    bmm)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = tiny_cfg()
    h, (n, r, c) = cfg.n_heads, (16, 8, 32)
    handed, real = [], kops.mla_decode

    def wrapper(q_lat, *a):
        handed.append(q_lat.dtype)
        with FakeTensorMode():
            fake = [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in (q_lat, *a[:3])]
            return real(*fake, *a[3:])

    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    monkeypatch.setattr(kops, "mla_decode", wrapper)
    g = torch.Generator().manual_seed(0)
    p = {"kv_b": {"w": torch.randn((c, h * (n + 16)), generator=g)}}
    args = [torch.randn(s, generator=g) for s in ((2, h, n), (2, h, r), (2, 10, c), (2, 10, r))]
    with torch.inference_mode(), pytest.raises(TypeError, match="bf16"):
        mla._absorbed(cfg, p, *args, 5)
    assert handed == [torch.float32]


def test_the_rooflines_analytic_count_of_the_mixer_is_the_benchmarks():
    from repro_torch.roofline.analytic import _mixer_fwd_flops_per_token

    m, cfg = full_m(), get_config("deepseek-v2-lite")
    kind = layers.load("mla")
    assert _mixer_fwd_flops_per_token(cfg, "mla", "decode", 32100) == 2 * kind.macs(m) + kind.key_flops(m) * 32100
