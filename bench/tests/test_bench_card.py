"""On the card, at each cell's own size: a sound run passes every limit, and
the control (fp8 products in the reference, put in the program's place)
and each planted fault fail at least one."""

import pytest

from bench.harness import core
from bench.tests import readings

pytestmark = pytest.mark.card


def limits_hold(values: dict, limits: dict) -> bool:
    return all(values[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell, seed", [("deepseek-moe-16b.decode", 2147483659), ("granite-moe-1b-a400m.train", 3000000049)])
def test_the_control_and_the_faults_fail_and_a_sound_run_passes(card, cell, seed):
    core.configure_env(core.ROOT)
    c = core.find_cell(core.load_spec(), cell)
    ctx = core.Ctx(seed, 0.0, False, c, "cuda", core.ROOT)
    run = {"serve": readings.serve_seed, "train": readings.train_seed}[c.workload["driver"]]
    got = run(ctx, control=True, faults=True)
    limits = c.workload["limits"]
    assert limits_hold(got.pop("program"), limits)
    assert got and all(not limits_hold(v, limits) for v in got.values()), got
