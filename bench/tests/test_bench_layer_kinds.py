"""The layer kinds and the named reference give the numbers the harness gave
before they were found by name: for both configurations at full width every
weight group's leaves and the FLOPs of a prefill, a decode step and a
training iteration, as exact integers; at the ``TINY_MODELS`` sizes on the
CPU, each leaf's sum and first 8 values.  The values were taken from the
harness as it was when ``bench/harness/weights.py`` and
``bench/counts/flops.py`` wrote the ``attn``, ``mlp``/``dense0`` and ``moe``
leaves and products inline.  Also: a kind or a reference that has no file
is refused, naming the file, and every dataclass section of the port's
``ModelConfig`` is built from the configuration's file."""

import copy
import json
import math

import pytest

from bench import layers
from bench.counts import flops
from bench.harness import core, port, weights
from bench.tests.conftest import TINY_MODELS

DS_HEAD = [
    (("embed",), (102400, 2048), 0.022097086912079608, False),
    (("final_norm", "w"), (2048,), 0.1, False),
    (("lm_head", "w"), (2048, 102400), 0.022097086912079608, False),
]
DS_DENSE = [
    (("norm1", "w"), (2048,), 0.1, False),
    (("mixer", "q", "w"), (2048, 2048), 0.022097086912079608, False),
    (("mixer", "k", "w"), (2048, 2048), 0.022097086912079608, False),
    (("mixer", "v", "w"), (2048, 2048), 0.022097086912079608, False),
    (("mixer", "o", "w"), (2048, 2048), 0.022097086912079608, False),
    (("norm2", "w"), (2048,), 0.1, False),
    (("ffn", "gate", "w"), (2048, 10944), 0.022097086912079608, False),
    (("ffn", "up", "w"), (2048, 10944), 0.022097086912079608, False),
    (("ffn", "down", "w"), (10944, 2048), 0.009558988911273407, False),
]
DS_MOE = [
    (("norm1", "w"), (2048,), 0.1, False),
    (("mixer", "q", "w"), (2048, 2048), 0.022097086912079608, False),
    (("mixer", "k", "w"), (2048, 2048), 0.022097086912079608, False),
    (("mixer", "v", "w"), (2048, 2048), 0.022097086912079608, False),
    (("mixer", "o", "w"), (2048, 2048), 0.022097086912079608, False),
    (("norm2", "w"), (2048,), 0.1, False),
    (("ffn", "router", "w"), (2048, 64), 0.022097086912079608, True),
    (("ffn", "gate"), (64, 2048, 1408), 0.022097086912079608, False),
    (("ffn", "up"), (64, 2048, 1408), 0.022097086912079608, False),
    (("ffn", "down"), (64, 1408, 2048), 0.026650089544451302, False),
    (("ffn", "shared", "gate", "w"), (2048, 2816), 0.022097086912079608, False),
    (("ffn", "shared", "up", "w"), (2048, 2816), 0.022097086912079608, False),
    (("ffn", "shared", "down", "w"), (2816, 2048), 0.018844459036110227, False),
]
GR_HEAD = [
    (("embed",), (49408, 1024), 0.03125, False),
    (("final_norm", "w"), (1024,), 0.1, False),
]
GR_MOE = [
    (("norm1", "w"), (1024,), 0.1, False),
    (("mixer", "q", "w"), (1024, 1024), 0.03125, False),
    (("mixer", "k", "w"), (1024, 512), 0.03125, False),
    (("mixer", "v", "w"), (1024, 512), 0.03125, False),
    (("mixer", "o", "w"), (1024, 1024), 0.03125, False),
    (("norm2", "w"), (1024,), 0.1, False),
    (("ffn", "router", "w"), (1024, 32), 0.03125, True),
    (("ffn", "gate"), (32, 1024, 512), 0.03125, False),
    (("ffn", "up"), (32, 1024, 512), 0.03125, False),
    (("ffn", "down"), (32, 512, 1024), 0.044194173824159216, False),
]

# (prefill(m, 32, 550), decode_step(m, 32, 600), train_iteration(m, 4, 512))
FLOPS = {
    "deepseek-moe-16b": (85926058393600, 172008407040, 32541524361216),
    "granite-moe-1b-a400m": (13795115335680, 29318381568, 5421662208000),
}
LEAVES = {
    "deepseek-moe-16b": (DS_HEAD, [DS_DENSE] + [DS_MOE] * 27),
    "granite-moe-1b-a400m": (GR_HEAD, [GR_MOE] * 24),
}

# Each leaf's (exact sum, first 8 values) of ``make_params`` from seed 12345 on the CPU.
TINY_SUMS = {
    "tiny-ds": {
        "embed": (14.632316503673792,
            [0.0849609375, 0.10791015625, -0.119140625, 0.051513671875, -0.06982421875, 0.0223388671875, -0.05517578125, -0.29296875]),
        "final_norm/w": (-0.0731048583984375,
            [0.025146484375, 0.0458984375, 0.009521484375, 0.12255859375, 0.025634765625, 0.00115966796875, -0.012451171875, 0.05078125]),
        "layers/0/ffn/down/w": (-1.2250175476074219,
            [0.09521484375, -0.0179443359375, -0.03271484375, 0.048095703125, 0.0272216796875, -0.04638671875, 0.00689697265625, -0.0098876953125]),
        "layers/0/ffn/gate/w": (-2.6586166620254517,
            [-0.07421875, 0.07421875, -0.1416015625, -0.1064453125, -0.146484375, -0.0615234375, 0.10986328125, -0.11474609375]),
        "layers/0/ffn/up/w": (-8.097312569618225,
            [0.04150390625, 0.19140625, 0.03759765625, -0.12158203125, 0.001739501953125, 0.0849609375, -0.220703125, -0.1083984375]),
        "layers/0/mixer/k/w": (-14.52069640159607,
            [-0.1953125, -0.208984375, 0.185546875, -0.083984375, -0.00213623046875, -0.04150390625, -0.06982421875, 0.150390625]),
        "layers/0/mixer/o/w": (-3.0820635557174683,
            [0.2021484375, -0.04931640625, -0.16015625, -0.154296875, 0.05810546875, 0.06884765625, -0.1318359375, 0.2236328125]),
        "layers/0/mixer/q/w": (2.6409597396850586,
            [0.0810546875, 0.1474609375, 0.0751953125, 0.1328125, 0.109375, 0.134765625, 0.050537109375, 0.0157470703125]),
        "layers/0/mixer/v/w": (9.887823104858398,
            [-0.025634765625, -0.0042724609375, 0.2265625, 0.12255859375, 0.053955078125, 0.06884765625, 0.1181640625, -0.1572265625]),
        "layers/0/norm1/w": (-0.025239944458007812,
            [-0.11083984375, 0.003814697265625, 0.05419921875, -0.00830078125, -0.06005859375, -0.064453125, 0.0888671875, 0.04345703125]),
        "layers/0/norm2/w": (-0.391815185546875,
            [-0.01531982421875, -0.0118408203125, -0.03466796875, 0.1689453125, -0.0286865234375, 0.21875, -0.06201171875, -0.0546875]),
        "layers/1/ffn/down": (-0.41142719984054565,
            [-0.3671875, -0.1181640625, 0.365234375, -0.01348876953125, -0.2490234375, 0.177734375, 0.166015625, -0.173828125]),
        "layers/1/ffn/gate": (17.408187210559845,
            [-0.09765625, 0.07275390625, 0.046875, -0.03857421875, -0.09228515625, 0.1533203125, -0.058349609375, -0.2099609375]),
        "layers/1/ffn/router/w": (2.397177738697792,
            [-0.07790874689817429, -0.09225446730852127, 0.09857133030891418, 0.03412184491753578, -0.12945544719696045, 0.20049475133419037, 0.31580525636672974, -0.145636186003685]),
        "layers/1/ffn/shared/down/w": (5.224804878234863,
            [0.126953125, 0.0257568359375, -0.036376953125, 0.002105712890625, -0.0302734375, 0.0771484375, 0.1337890625, 0.0654296875]),
        "layers/1/ffn/shared/gate/w": (-1.1519746780395508,
            [0.036376953125, 0.0047607421875, -0.0341796875, 0.1455078125, 0.17578125, -0.0177001953125, 0.06884765625, 0.02685546875]),
        "layers/1/ffn/shared/up/w": (4.9563226997852325,
            [-0.265625, 0.06787109375, -0.046142578125, 0.01531982421875, -0.11279296875, -0.03515625, 0.09521484375, 0.08642578125]),
        "layers/1/ffn/up": (-12.306527733802795,
            [-0.032958984375, 0.07666015625, 0.1669921875, 0.036865234375, 0.115234375, 0.275390625, -0.1396484375, -0.19140625]),
        "layers/1/mixer/k/w": (12.714954376220703,
            [-0.0458984375, 0.02490234375, -0.1298828125, -0.058837890625, 0.2080078125, -0.232421875, -0.1748046875, 0.072265625]),
        "layers/1/mixer/o/w": (0.19928193092346191,
            [0.166015625, -0.0311279296875, -0.05810546875, -0.040771484375, 0.251953125, 0.1259765625, -0.02099609375, 0.10888671875]),
        "layers/1/mixer/q/w": (9.867120705544949,
            [-0.07666015625, -0.08154296875, -0.02294921875, -0.034423828125, 0.01470947265625, 0.0751953125, 0.306640625, -0.22265625]),
        "layers/1/mixer/v/w": (1.5480602979660034,
            [-0.12451171875, 0.19921875, -0.059814453125, 0.041748046875, 0.07080078125, 0.026611328125, -0.14453125, -0.099609375]),
        "layers/1/norm1/w": (0.8916473388671875,
            [0.21875, -0.037353515625, -0.1513671875, 0.1044921875, -0.126953125, -0.032470703125, 0.1474609375, -0.11962890625]),
        "layers/1/norm2/w": (0.9098548889160156,
            [0.06884765625, -0.10693359375, 0.00823974609375, 0.0279541015625, -0.01806640625, 0.000164031982421875, 0.00185394287109375, 0.064453125]),
        "lm_head/w": (10.795820195693523,
            [-0.1162109375, -0.05029296875, 0.0400390625, -0.00152587890625, -0.1640625, 0.07763671875, 0.02392578125, -0.08935546875]),
    },
    "tiny-gr": {
        "embed": (14.632316503673792,
            [0.0849609375, 0.10791015625, -0.119140625, 0.051513671875, -0.06982421875, 0.0223388671875, -0.05517578125, -0.29296875]),
        "final_norm/w": (-0.0731048583984375,
            [0.025146484375, 0.0458984375, 0.009521484375, 0.12255859375, 0.025634765625, 0.00115966796875, -0.012451171875, 0.05078125]),
        "layers/0/ffn/down": (-11.695740699768066,
            [0.1904296875, -0.035888671875, -0.0654296875, 0.09619140625, 0.054443359375, -0.0927734375, 0.0137939453125, -0.019775390625]),
        "layers/0/ffn/gate": (-8.86671781539917,
            [-0.0269775390625, 0.0791015625, -0.08740234375, -0.1748046875, 0.078125, -0.06396484375, 0.265625, 0.043701171875]),
        "layers/0/ffn/router/w": (-2.365617691713851,
            [0.05399464815855026, 0.03794344514608383, -0.09824210405349731, -0.02955300733447075, -0.03790731728076935, -0.059423789381980896, 0.13924290239810944, 0.07595138251781464]),
        "layers/0/ffn/up": (-5.469977974891663,
            [0.053466796875, -0.028564453125, 0.039794921875, -0.04052734375, 0.04296875, -0.022216796875, 0.044677734375, 0.10302734375]),
        "layers/0/mixer/k/w": (-3.3592793941497803,
            [-0.1953125, -0.208984375, 0.185546875, -0.083984375, -0.00213623046875, -0.04150390625, -0.06982421875, 0.150390625]),
        "layers/0/mixer/o/w": (9.887823104858398,
            [-0.025634765625, -0.0042724609375, 0.2265625, 0.12255859375, 0.053955078125, 0.06884765625, 0.1181640625, -0.1572265625]),
        "layers/0/mixer/q/w": (2.6409597396850586,
            [0.0810546875, 0.1474609375, 0.0751953125, 0.1328125, 0.109375, 0.134765625, 0.050537109375, 0.0157470703125]),
        "layers/0/mixer/v/w": (-11.161417007446289,
            [-0.103515625, -0.2080078125, 0.033935546875, 0.07275390625, -0.134765625, 0.21875, 0.033935546875, 0.1337890625]),
        "layers/0/norm1/w": (-0.025239944458007812,
            [-0.11083984375, 0.003814697265625, 0.05419921875, -0.00830078125, -0.06005859375, -0.064453125, 0.0888671875, 0.04345703125]),
        "layers/0/norm2/w": (0.00811767578125,
            [0.162109375, -0.03955078125, -0.1279296875, -0.12353515625, 0.04638671875, 0.05517578125, -0.10546875, 0.1787109375]),
        "layers/1/ffn/down": (-25.246122360229492,
            [0.298828125, -0.10986328125, 0.17578125, -0.345703125, -0.265625, -0.11474609375, -0.2890625, 0.0130615234375]),
        "layers/1/ffn/gate": (9.622183799743652,
            [-0.140625, -0.076171875, -0.2412109375, -0.08935546875, -0.193359375, -0.01275634765625, 0.034423828125, 0.05517578125]),
        "layers/1/ffn/router/w": (-0.4213089128897991,
            [-0.009801702573895454, 0.08503007143735886, 0.053195398300886154, 0.1149805560708046, -0.12008477002382278, 0.026605235412716866, 0.06194552034139633, 0.08175298571586609]),
        "layers/1/ffn/up": (-0.036183297634124756,
            [0.08349609375, 0.11279296875, -0.00506591796875, -0.01220703125, -0.08203125, -0.05224609375, 0.1513671875, 0.1591796875]),
        "layers/1/mixer/k/w": (2.3457860946655273,
            [-0.0458984375, 0.02490234375, -0.1298828125, -0.058837890625, 0.2080078125, -0.232421875, -0.1748046875, 0.072265625]),
        "layers/1/mixer/o/w": (1.5480602979660034,
            [-0.12451171875, 0.19921875, -0.059814453125, 0.041748046875, 0.07080078125, 0.026611328125, -0.14453125, -0.099609375]),
        "layers/1/mixer/q/w": (9.867120705544949,
            [-0.07666015625, -0.08154296875, -0.02294921875, -0.034423828125, 0.01470947265625, 0.0751953125, 0.306640625, -0.22265625]),
        "layers/1/mixer/v/w": (10.369168281555176,
            [0.00811767578125, 0.1513671875, 0.134765625, -0.080078125, 0.037109375, -0.00579833984375, -0.053955078125, -0.0140380859375]),
        "layers/1/norm1/w": (0.8916473388671875,
            [0.21875, -0.037353515625, -0.1513671875, 0.1044921875, -0.126953125, -0.032470703125, 0.1474609375, -0.11962890625]),
        "layers/1/norm2/w": (1.6669535636901855,
            [0.1328125, -0.02490234375, -0.04638671875, -0.03271484375, 0.201171875, 0.1005859375, -0.016845703125, 0.0869140625]),
    },
}


def model_of(name: str, over: dict | None = None) -> dict:
    conf = json.loads((core.ROOT / "bench" / "configs" / f"{name}.json").read_text())
    conf["model"].update(copy.deepcopy(over or {}))
    return {**conf["model"], **conf["numerics"]}


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_every_group_at_full_width_has_the_parents_leaves(name):
    m = model_of(name)
    head, body = LEAVES[name]
    assert weights.group_leaves(m, 0) == head
    assert [weights.group_leaves(m, 1 + i) for i in range(m["n_layers"])] == body


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_the_flops_at_full_width_are_the_parents(name):
    m = model_of(name)
    got = (flops.prefill(m, 32, 550), flops.decode_step(m, 32, 600), flops.train_iteration(m, 4, 512))
    assert got == FLOPS[name] and all(isinstance(v, int) for v in got)


@pytest.mark.parametrize("tiny", sorted(TINY_SUMS))
def test_the_tiny_weights_are_the_parents(tiny):
    arch, over = TINY_MODELS[tiny]
    params = weights.make_params(model_of(arch, over), 12345, "cpu")
    got = {path: (math.fsum(t.double().reshape(-1).tolist()), t.reshape(-1)[:8].double().tolist())
           for path, t in weights.flatten(params)}
    assert got == TINY_SUMS[tiny]


@pytest.mark.parametrize("where", [0, 1])
def test_a_layer_kind_without_a_file_is_refused_naming_it(where):
    kind = ["attn", "mlp"]
    kind[where] = "no_such_kind"
    m = model_of("granite-moe-1b-a400m", {"pattern": [kind]})
    calls = [lambda: weights.group_leaves(m, 1), lambda: flops.body_macs(m)]
    if where == 0:
        calls.append(lambda: flops.attention_flops(m, 10))
    for call in calls:
        with pytest.raises(core.Refused, match="bench/layers/no_such_kind.py"):
            call()


def test_each_kind_module_gives_its_interface():
    m = model_of("deepseek-moe-16b")
    assert layers.load("attn").key_flops(m) == 4 * 16 * 128
    assert layers.load("dense0").leaves(m) == layers.load("mlp").leaves(m)
    for kind in ("attn", "mlp", "dense0", "moe"):
        mod = layers.load(kind)
        assert mod.macs(m) > 0 and all(len(leaf) == 4 for leaf in mod.leaves(m))


def test_the_port_builds_every_dataclass_section_from_the_file():
    from repro_torch.models.config import MoECfg, SSMCfg

    conf = {"name": "jamba-test", "arch": "jamba-v0.1-52b",
            "model": {"ssm": {"d_state": 8, "expand": 2}, "moe": {"top_k": 1}}}
    cfg = port.config(conf)
    # Keys the section leaves out keep the registry entry's values (its chunk is 512, the class's 1024).
    assert cfg.ssm == SSMCfg(d_state=8, d_conv=4, expand=2, chunk=512)
    assert isinstance(cfg.moe, MoECfg) and cfg.moe.top_k == 1 and cfg.moe.n_experts == 16


def test_the_reference_is_the_module_the_configuration_names():
    from bench.reference import moe_decoder

    conf = json.loads((core.ROOT / "bench" / "configs" / "deepseek-moe-16b.json").read_text())
    ref = core.load_reference(conf)
    assert ref is moe_decoder
    for fn in ("serve_logits", "gaps", "forward_loss", "fp32_mm", "fp8_mm", "exact_fp32"):
        assert callable(getattr(ref, fn))
    for bad in ("bench/reference/no_such_reference.py", "bench/harness/core.py", None):
        with pytest.raises(core.Refused, match="bench/reference/"):
            core.load_reference({**conf, "reference": bad} if bad else {"name": "x"})
