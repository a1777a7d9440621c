"""The port's MoE FFN (``repro_torch.models.moe``) against ``repro.models.moe``.

Weights are the reference's own ``init_moe``, carried across bit for bit
(bf16 as ``uint16`` bits); inputs are made with numpy from a seed.

* Routing is held **equal**: the experts each token chose, each choice's
  slot in its expert's buffer and the keep mask, at ample capacity
  (``capacity_factor`` 8, nothing dropped) and at tight capacity (0.25,
  where choices are dropped).  The reference does not return its routing,
  so :func:`jax_routing` repeats its lines (``src/repro/models/moe.py``,
  ``apply_moe``) in ``jax.numpy``; the outputs below then hold the port to
  the reference's own function.
* ``y`` and ``aux`` against the reference's ``apply_moe``: fp32 2e-5 and
  bf16 2e-2, atol and rtol (``TOL`` of ``tests/test_kernels.py``; the
  expert products sum in other orders, and a bf16 product rounds to its
  neighbour).

The five tests of ``tests/test_moe.py`` follow, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.config import ModelConfig as JConfig
from repro.models.config import MoECfg as JMoE
from repro.models.moe import apply_moe as japply
from repro.models.moe import init_moe as jinit
from repro.models.moe import moe_capacity as jcapacity
from repro_torch._bridge import to_torch, tree_map
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, MoECfg
from repro_torch.models.layers import linear

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(e=4, k=2, cf=4.0, shared=0, d=32, d_e=16, dtype="float32"):
    kw = dict(name="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2, d_ff=0, vocab=64,
              dtype=dtype, remat=False, pattern=(("attn", "moe"),))
    moe = dict(n_experts=e, top_k=k, d_expert=d_e, n_shared=shared, capacity_factor=cf)
    return JConfig(**kw, moe=JMoE(**moe)), ModelConfig(**kw, moe=MoECfg(**moe))


def _host(tree):
    return jax.tree.map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a), tree
    )


def _params(jcfg, seed=0):
    jp = jinit(jax.random.key(seed), jcfg, jnp.dtype(jcfg.dtype))
    return jp, tree_map(to_torch, _host(jp))


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def jax_routing(cfg, p, x):
    """The reference's routing, its lines repeated: ``(experts [T, k], slot
    [T·k], keep [T·k])``."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"]["w"], axis=-1)
    _, experts = jax.lax.top_k(probs, m.top_k)
    flat_e = experts.reshape(t * m.top_k)
    onehot = jax.nn.one_hot(flat_e, m.n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(experts), np.asarray(slot), np.asarray(slot < jcapacity(cfg, t))


CASES = {
    # name: (cfg kwargs, x shape); d_e 16 unless given
    "ample-shared": (dict(e=4, k=2, cf=8.0, shared=1), (2, 8)),
    "tight-drops": (dict(e=4, k=2, cf=0.25), (2, 32)),
    "tight-shared-top3": (dict(e=6, k=3, cf=0.25, shared=2), (3, 16)),
    "decode-min-capacity": (dict(e=8, k=2, cf=1.25), (4, 1)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_routes_drops_and_computes_as_the_reference(case, dtype):
    kw, (b, l) = CASES[case]
    jcfg, tcfg = _cfgs(**kw, dtype=dtype)
    jp, tp = _params(jcfg)
    assert tp["router"]["w"].dtype == torch.float32  # fp32 router in a bf16 model
    assert tp["gate"].dtype == getattr(torch, dtype)
    jx, tx = _x(1, (b, l, jcfg.d_model), dtype)

    experts, slot, keep = jax_routing(jcfg, jp, jx)
    r = tmoe.route(tcfg, tp, tx.reshape(b * l, -1))
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert tmoe.moe_capacity(tcfg, b * l) == jcapacity(jcfg, b * l)
    if case.startswith("tight"):
        assert not keep.all()  # choices are dropped here
    else:
        assert keep.all()

    jy, jaux = japply(jcfg, jp, jx)
    ty, taux = tmoe.apply_moe(tcfg, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert taux.dtype == torch.float32 and taux.ndim == 0
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=tol, rtol=tol)


def test_ties_go_to_the_lower_expert_as_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1]],
                     np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 3)
    vals, got = tmoe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())


def test_a_dropped_choice_does_not_overwrite_the_kept_token_in_the_last_slot():
    # Every token routes to expert 0 (a collapsed router): slots 0..C-1 are
    # kept, the rest go to slot C-1 with zero rows, which must add, not overwrite.
    jcfg, tcfg = _cfgs(e=4, k=1, cf=1.0)
    jp, tp = _params(jcfg)
    w = np.zeros((jcfg.d_model, 4), np.float32)
    w[:, 0] = 1.0
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp = dict(tp, router={"w": torch.from_numpy(w)})
    jx, tx = _x(2, (1, 32, jcfg.d_model), "float32")
    jx, tx = jnp.abs(jx), tx.abs()  # positive rows: every token picks expert 0
    cap = tmoe.moe_capacity(tcfg, 32)
    r = tmoe.route(tcfg, tp, tx.reshape(32, -1))
    assert int(r.keep.sum()) == cap < 32
    jy, _ = japply(jcfg, jp, jx)
    ty, _ = tmoe.apply_moe(tcfg, tp, tx)
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=TOL["float32"], rtol=TOL["float32"])
    assert float(ty[0, cap - 1].abs().sum()) > 0  # the last kept token's output survives
    assert float(ty[0, cap:].abs().sum()) == 0  # dropped tokens fall through the residual


# -- tests/test_moe.py on the port --------------------------------------------


def _cfg(e=4, k=2, cf=4.0, shared=0):
    return _cfgs(e=e, k=k, cf=cf, shared=shared)[1]


def _init(cfg, seed=0):
    return tmoe.init_moe(torch.Generator().manual_seed(seed), cfg, torch.float32)


def _randn(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _dense_reference(cfg, p, x):
    """Route every token to its top-k experts with no capacity limit."""
    m = cfg.moe
    b, l, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(linear(p["router"], xf.float()), dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(m.n_experts):
        oe = (F.silu(xf @ p["gate"][e]) * (xf @ p["up"][e])) @ p["down"][e]
        for j in range(m.top_k):
            sel = (idx[:, j] == e).to(xf.dtype)[:, None]
            y = y + oe * sel * w[:, j : j + 1].to(xf.dtype)
    if "shared" in p:
        sh = p["shared"]
        y = y + linear(sh["down"], F.silu(linear(sh["gate"], xf)) * linear(sh["up"], xf))
    return y.reshape(b, l, d)


def test_matches_dense_reference_with_ample_capacity():
    cfg = _cfg(cf=8.0, shared=1)
    p = _init(cfg)
    x = _randn(1, 2, 8, cfg.d_model) * 0.5
    y, aux = tmoe.apply_moe(cfg, p, x)
    np.testing.assert_allclose(y.numpy(), _dense_reference(cfg, p, x).numpy(), atol=1e-4)
    assert float(aux) > 0.0


def test_capacity_drops_reduce_output():
    """With capacity 0-ish, routed output vanishes (residual falls through)."""
    cfg = _cfg(cf=0.01)
    p = _init(cfg)
    x = _randn(1, 2, 32, cfg.d_model)
    y, _ = tmoe.apply_moe(cfg, p, x)
    y_full, _ = tmoe.apply_moe(_cfg(cf=8.0), p, x)
    assert float(y.abs().mean()) < float(y_full.abs().mean())


def test_capacity_formula():
    cfg = _cfg(e=8, k=2, cf=1.25)
    c = tmoe.moe_capacity(cfg, 1024)
    assert c >= 1024 * 2 / 8 * 1.25
    assert c % 4 == 0
    jcfg = _cfgs(e=8, k=2, cf=1.25)[0]
    for n in (1, 4, 7, 512, 1024, 4096):  # and the reference's value
        assert tmoe.moe_capacity(cfg, n) == jcapacity(jcfg, n)


def test_aux_loss_balanced_vs_skewed():
    """Uniform routing gives aux ≈ 1; collapsed routing gives aux > 1."""
    cfg = _cfg(e=4, k=1, cf=8.0)
    p = _init(cfg)
    x = _randn(1, 4, 64, cfg.d_model)
    _, aux_rand = tmoe.apply_moe(cfg, p, x)
    w = torch.zeros((cfg.d_model, 4))
    w[:, 0] += 1.0  # force collapse: bias the router to expert 0
    _, aux_collapsed = tmoe.apply_moe(cfg, dict(p, router={"w": w}), x)
    assert float(aux_collapsed) > float(aux_rand)


def test_grads_flow_through_router():
    cfg = _cfg(cf=4.0)
    p = tree_map(lambda t: t.requires_grad_(), _init(cfg))
    x = _randn(1, 2, 8, cfg.d_model)
    y, aux = tmoe.apply_moe(cfg, p, x)
    (torch.sum(y * y) + 0.01 * aux).backward()
    assert float(p["router"]["w"].grad.abs().sum()) > 0.0
    assert float(p["gate"].grad.abs().sum()) > 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_the_reference(dtype):
    """Every leaf's gradient, and the input's, against ``jax.grad`` of the
    reference at tight capacity (drops included)."""
    jcfg, tcfg = _cfgs(e=6, k=3, cf=0.5, shared=1, dtype=dtype)
    jp, tp = _params(jcfg)
    jx, tx = _x(3, (2, 16, jcfg.d_model), dtype)

    def jloss(p, x):
        y, aux = japply(jcfg, p, x)
        return jnp.sum(jnp.square(y.astype(jnp.float32))) + 0.5 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    tx = tx.requires_grad_()
    y, aux = tmoe.apply_moe(tcfg, tp, tx)
    (torch.sum(torch.square(y.float())) + 0.5 * aux).backward()
    got = [tp["router"]["w"].grad, tp["gate"].grad, tp["up"].grad, tp["down"].grad,
           tp["shared"]["gate"]["w"].grad, tp["shared"]["up"]["w"].grad,
           tp["shared"]["down"]["w"].grad, tx.grad]
    want = [jg["router"]["w"], jg["gate"], jg["up"], jg["down"], jg["shared"]["gate"]["w"],
            jg["shared"]["up"]["w"], jg["shared"]["down"]["w"], jgx]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _f32(a), _f32(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=str(i))
        else:
            assert np.linalg.norm(a - b) <= TOL[dtype] * np.linalg.norm(b), i
