"""The plain reference against the port's CPU path at smoke sizes, in fp32,
where the two must agree to rounding: served logits through prefill and
decode (routing, capacity and drops included), and three training
iterations (loss, gradient sync, AdamW)."""

import copy

import pytest
import torch

from bench.drivers import train
from bench.harness import core, port, weights
from bench.reference import moe_decoder as ref
from bench.reference import train_step
from bench.tests.conftest import TINY_MODELS


def fp32_config(name: str, **moe) -> dict:
    arch, model = TINY_MODELS[name]
    import json

    conf = json.loads((core.ROOT / "bench" / "configs" / f"{arch}.json").read_text())
    conf["model"].update(copy.deepcopy(model), dtype="float32")
    conf["model"]["moe"].update(moe)
    return conf


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])  # 0.25 drops choices
def test_served_logits_agree_with_the_port(capacity_factor):
    conf = fp32_config("tiny-ds", capacity_factor=capacity_factor)
    m = {**conf["model"], **conf["numerics"]}
    b, l0, g, seed = 3, 8, 6, 12345
    model = port.model(conf, "cpu")
    params = weights.make_params(m, seed, "cpu")
    prompts = torch.randint(0, m["vocab"], (b, l0), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    cache = model.init_cache(b, l0 + g)
    got, toks = [], []
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts, cache)
        for _ in range(g):
            got.append(logits[:, -1, : m["vocab"]])
            toks.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
            logits, cache = model.decode_step(params, toks[-1][:, None], cache)
    served = torch.stack(toks, dim=1)
    want = ref.serve_logits(m, lambda grp: weights.make_group(m, grp, seed, "cpu"), prompts, served)[0]
    torch.testing.assert_close(torch.stack(got, dim=1), want, rtol=1e-4, atol=1e-4)
    assert float(ref.gaps(want, served).max()) < 1e-4
    if capacity_factor < 1:  # the prefill's capacity does drop choices here
        assert ref.capacity(m, b * l0) < b * l0 * m["moe"]["top_k"] / m["moe"]["n_experts"]


def test_three_training_iterations_agree_with_the_port(tiny_root):
    import json

    conf = fp32_config("tiny-gr")
    (tiny_root / "bench" / "configs" / "tiny-gr.json").write_text(json.dumps(conf | {"name": "tiny-gr"}))
    cell = core.find_cell(core.load_spec(tiny_root), "tiny-gr.train", tiny_root)
    ctx = core.Ctx(99, 0.0, False, cell, "cpu", tiny_root)
    st = train.setup(ctx)
    got = train.readings(st)
    train.release(st)
    gaps = train.gaps(got, train.reference(ctx))
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_norm_gap"] < 1e-4 and gaps["update_norm_gap"] < 1e-3, gaps
    assert gaps["grad_diff_worst"] < 1e-4, gaps


def test_the_quantiser_is_the_ports():
    from repro_torch.optim.compress import compress, decompress

    g = torch.randn(5, 7, generator=torch.Generator().manual_seed(3)) * 1e-3
    c, err = compress({"w": g})
    torch.testing.assert_close(decompress(c)["w"], train_step.quantise(g), rtol=0, atol=0)
    torch.testing.assert_close(err["w"], g - train_step.quantise(g), rtol=0, atol=0)


def test_the_schedule_is_the_ports():
    from repro_torch.optim.adamw import AdamWConfig, schedule

    opt = AdamWConfig(warmup_steps=100, total_steps=1000)
    for step in (1, 2, 3, 99, 100, 101, 550, 1000, 1200):
        want = float(schedule(opt, torch.tensor(step, dtype=torch.int32)))
        assert train_step.lr_at(vars(opt), step) == pytest.approx(want, rel=1e-6)


def test_the_control_reads_further_from_the_reference_than_the_program():
    conf = fp32_config("tiny-ds")
    m = {**conf["model"], **conf["numerics"]}
    prompts = torch.randint(0, m["vocab"], (3, 8), generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    served = torch.randint(0, m["vocab"], (3, 6), generator=torch.Generator().manual_seed(6), dtype=torch.int32)
    want, control = ref.serve_logits(m, lambda grp: weights.make_group(m, grp, 5, "cpu"), prompts, served,
                                     (ref.fp32_mm, ref.fp8_mm))
    assert float(ref.gaps(want, control.argmax(dim=-1)).max()) > 1e-2
    assert float(ref.gaps(want, want.argmax(dim=-1)).max()) == 0.0


@pytest.mark.parametrize("kind", [("mamba", "moe"), ("attn", "none")])
def test_a_layer_of_another_kind_is_refused_not_computed_as_attention(kind):
    conf = fp32_config("tiny-ds")
    m = {**conf["model"], **conf["numerics"]}
    p = weights.make_group(m, 2, 1, "cpu")
    x = torch.zeros(1, 4, m["d_model"])
    with pytest.raises(ValueError, match="does not compute"):
        ref.block(m, kind, ref.f32(p), x, [torch.arange(4)], ref.fp32_mm)
