"""The routing look on the CPU at a tiny size: the port's routing calls
line up with the reference's, and a flip planted in the port's routing is
found at the token and layer where it was planted."""

import pytest

from bench.harness import core
from bench.tests import routing


def ctx_of(root, cell, seed=7):
    core.configure_env(root)
    return core.Ctx(seed, 0.0, False, core.find_cell(core.load_spec(root), cell, root), "cpu", root)


def test_every_served_token_is_lined_up_with_its_reference_position(tiny_root):
    got = routing.serve_look(ctx_of(tiny_root, "tiny-ds.decode"))
    assert got["tokens"] == 3 * 6 and got["port_calls"] == 6  # a prefill and 5 steps; layer 0 is dense
    assert got["tokens_with_a_flip"] == 0 and got["gap_mean_without"] < 0.01, got


def test_a_planted_flip_is_found_where_it_was_planted(tiny_root, monkeypatch):
    from repro_torch.models import moe

    calls, route = [], moe.route

    def flipped(cfg, p, xf):
        r = route(cfg, p, xf)
        calls.append(xf.shape[0])
        # One MoE layer (layer 0 is dense): the warm-up is a prefill and 2
        # steps (3 calls), then the batch's prefill: the 5th is decode step 1.
        if len(calls) == 5:
            r.experts[1] = (r.experts[1] + 1) % cfg.moe.n_experts
        return r

    monkeypatch.setattr(moe, "route", flipped)
    got = routing.serve_look(ctx_of(tiny_root, "tiny-ds.decode"))
    assert got["flips"] >= 1 and got["tokens_with_a_flip"] >= 1


def test_each_reference_call_of_the_first_iteration_is_matched_twice(tiny_root):
    got = routing.train_look(ctx_of(tiny_root, "tiny-gr.train"))
    assert got["each_ref_call_matched"] and got["ref_calls_first_iteration"] == 2 * 2
    assert set(got["flips_by_layer"]) == {"0", "1"}
    assert len(got["grad_diff_worst_leaves"]) == 5


@pytest.mark.parametrize("cell", ["deepseek-moe-16b.decode", "granite-moe-1b-a400m.train"])
def test_the_real_cells_have_a_look(cell):
    c = core.find_cell(core.load_spec(), cell)
    assert c.workload["driver"] in ("serve", "train")
