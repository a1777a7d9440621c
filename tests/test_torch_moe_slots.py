"""The MoE slot kernel (``kernels/moe_slots.py``, ``csrc/moe_slots.cu``).

On the CPU:

* the plain version, ``ref.moe_slots_ref``, equals the JAX reference's slots
  and keep mask (``tests/test_torch_moe.py``'s ``jax_routing``, the lines of
  ``repro.models.moe.apply_moe``) over prompts of 1 to 550 tokens, the
  configs' (E, k) and capacity factors from 0.25 (most choices dropped) to 8
  (none), and with a collapsed router, every token on the same experts;
* the launch plan: 1 launch up to a chunk of choices, 2 above;
* a CPU tensor takes the plain version and counts no launch, and the wrapper
  refuses what the kernel does not take;
* on the kernel path the model's MoE calls the wrapper once a layer, and
  ``chip_smoke.serve_launches`` / ``train_launches`` count it so.

On the card (``-m card``; they skip here) the kernel equals the plain version
bit for bit at the benchmark cells' slot calls and the chunk's edges
(``chip_smoke.slot_shapes``), routed and collapsed, inside a captured and
replayed CUDA graph, and with no host sync::

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_moe_slots.py

``chip_smoke.py --moe-slots OUT`` (phase 20) times it beside its plain
version, one ``torch.cumsum`` and its bound.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import moe_slots as kslots
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import moe as tmoe


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_slot_tests",
                                                  Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_moe():
    """``tests/test_torch_moe.py``, whose helpers run the JAX reference (imported
    here, so that the card's tests of this file need no JAX)."""
    pytest.importorskip("jax")
    import test_torch_moe

    return test_torch_moe


# -- the plain version against the JAX reference -------------------------------------------


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("e,k", [(16, 2), (32, 8), (64, 6)])
@pytest.mark.parametrize("t", [1, 7, 32, 550])
def test_plain_slots_equal_the_jax_reference(jax_moe, t, e, k, cf):
    jcfg, tcfg = jax_moe._cfgs(e=e, k=k, cf=cf)
    jp, _ = jax_moe._params(jcfg)
    jx, _ = jax_moe._x(t, (1, t, jcfg.d_model), "float32")
    experts, slot, keep = jax_moe.jax_routing(jcfg, jp, jx)
    cap = tmoe.moe_capacity(tcfg, t)
    got = kref.moe_slots_ref(torch.from_numpy(np.array(experts)).long(), e, cap)
    np.testing.assert_array_equal(got[0].numpy(), slot)
    np.testing.assert_array_equal(got[1].numpy(), keep)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool


@pytest.mark.parametrize("e,k", [(16, 2), (32, 8), (64, 6)])
def test_plain_slots_of_a_collapsed_router_equal_the_jax_reference(jax_moe, e, k):
    """Every token on the same k experts: each of them keeps its capacity's
    first choices, the rest drop."""
    import jax
    import jax.numpy as jnp

    t = 550
    _, tcfg = jax_moe._cfgs(e=e, k=k, cf=1.25)
    cap = tmoe.moe_capacity(tcfg, t)
    experts = np.tile(np.arange(k), (t, 1))
    flat_e = jnp.asarray(experts).reshape(t * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)  # the reference's lines
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = np.asarray(jnp.sum(pos * onehot, axis=-1))
    got = kref.moe_slots_ref(torch.from_numpy(experts).long(), e, cap)
    np.testing.assert_array_equal(got[0].numpy(), slot)
    np.testing.assert_array_equal(got[1].numpy(), slot < cap)
    assert int(got[1].sum()) == k * cap < t * k


# -- the launch plan, the wrapper's CPU path and its refusals --------------------------------


@pytest.mark.parametrize("n", [1, kslots.CHUNK - 1, kslots.CHUNK, kslots.CHUNK + 1, 2 * kslots.CHUNK - 1,
                               2 * kslots.CHUNK, 2 * kslots.CHUNK + 1, 768_000])
def test_the_launch_plan_is_one_launch_up_to_a_chunk_and_two_above(n):
    chunks, launches = kslots.plan(n)
    assert chunks == -(-n // kslots.CHUNK) and (chunks - 1) * kslots.CHUNK < n <= chunks * kslots.CHUNK
    assert launches == (1 if n <= kslots.CHUNK else 2)


def test_a_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    g = torch.Generator().manual_seed(0)
    experts = torch.sort(torch.rand(300, 64, generator=g), dim=-1, descending=True, stable=True)[1][:, :6]
    kops.reset_launch_counts()
    got = kops.moe_slots(experts, 64, 32)
    want = kref.moe_slots_ref(experts, 64, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[1].all()  # 1800 choices over 64 experts of 32 slots: some drop
    assert kops.launch_counts() == {}


@pytest.mark.parametrize("case", ["int32 ids", "3-D ids", "no experts", "257 experts"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Fake CUDA tensors stand in for the card's: each is refused before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, dtype, e = {"int32 ids": ((8, 2), torch.int32, 16), "3-D ids": ((2, 8, 2), torch.int64, 16),
                       "no experts": ((8, 2), torch.int64, 0), "257 experts": ((8, 2), torch.int64, 257)}[case]
    with FakeTensorMode():
        ids = torch.empty(shape, dtype=dtype, device="cuda")
        with pytest.raises((TypeError, ValueError)):
            kslots.moe_slots(ids, e, 8)


# -- the model on the kernel path ------------------------------------------------------------


def test_the_moe_calls_the_slot_wrapper_once_a_call_on_the_kernel_path(monkeypatch):
    """With the switch forced to the kernel path, ``apply_moe`` takes its slots
    from ``ops.moe_slots`` (the plain version on CPU tensors, counted as the
    card's call), once a call, and gives the plain path's output."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True), dtype="float32")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(1))
    kops.reset_launch_counts()
    plain = tmoe.apply_moe(cfg, p, x)
    assert kops.launch_counts() == {}
    monkeypatch.setattr(kops, "use_kernel", lambda t: True)
    kern = tmoe.apply_moe(cfg, p, x)
    assert kops.launch_counts() == {"moe_slots": 1}
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])


@pytest.mark.parametrize("arch,n_moe", [("deepseek-moe-16b", 27), ("deepseek-v2-lite", 26),
                                        ("granite-moe-1b-a400m", 24), ("llama3.2-3b", 0)])
def test_chip_smoke_counts_one_slot_call_a_moe_layer_and_forward(arch, n_moe):
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch), remat=True)
    prefill, step = cs.serve_launches(cfg)
    assert prefill.get("moe_slots", 0) == step.get("moe_slots", 0) == n_moe
    assert cs.train_launches(cfg, 2).get("moe_slots", 0) == 2 * 2 * n_moe  # each pod's forward and remat's
    assert cs.dist_launches(cfg, hinted=False).get("moe_slots", 0) == 2 * n_moe
    assert "moe_slots" not in cs.dist_launches(cfg, hinted=True)  # H2's own cumsum


# -- on the card -----------------------------------------------------------------------------


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA device (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m card")
    return _chip_smoke()


def _equal(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("collapsed", [False, True], ids=["routed", "collapsed"])
def test_the_kernel_equals_the_plain_version_bit_for_bit(card, collapsed):
    for i, (name, (t, k, e, cap)) in enumerate(card.slot_shapes(get_config).items()):
        ids = card.slot_ids(torch, t, k, e, 1000 + i, "cuda", collapsed=collapsed)
        kops.reset_launch_counts()
        got = kops.moe_slots(ids, e, cap)
        assert kops.launch_counts() == {"moe_slots": 1}, name
        assert _equal(got, kref.moe_slots_ref(ids, e, cap)), name


@pytest.mark.card
@pytest.mark.parametrize("name", ["deepseek-moe-16b decode step", "granite-moe-1b-a400m train pod",
                                  "deepseek-v2-lite prefill"])
def test_a_replayed_graph_of_the_kernel_equals_the_plain_version_with_no_host_sync(card, name):
    t, k, e, cap = card.slot_shapes(get_config)[name]
    static = card.slot_ids(torch, t, k, e, 7, "cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kops.moe_slots(static, e, cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kops.moe_slots(static, e, cap)
    for seed in range(3):
        ids = card.slot_ids(torch, t, k, e, 20 + seed, "cuda")
        want = kref.moe_slots_ref(ids, e, cap)
        static.copy_(ids)
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the replay or the wrapper raises
        try:
            graph.replay()
            eager = kops.moe_slots(ids, e, cap)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _equal(out, want) and _equal(eager, want), (name, seed)
