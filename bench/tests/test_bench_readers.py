"""Each metric reader, and the trace's reduction to a record, on canned input."""

import pytest

from bench.harness import core
from bench.harness.profile import record_from_events


def reader(name):
    return core.load_reader(name).read


M = {"n_layers": 1, "d_model": 16, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8, "d_ff": 8, "vocab": 10,
     "prefix_pattern": [], "pattern": [["attn", "mlp"]]}


def canned():
    return {
        "device": [("decode_split_kernel<bf16,8>", 0.0, 1.0, 1), ("gemv", 2.0, 30.0, 2),
                   ("decode_split_kernel<bf16,8>", 40.0, 1.0, 3), ("gemv", 50.0, 60.0, 4),
                   ("copy", 120.0, 4.0, 5), ("gemv", 130.0, 4.0, 6)],
        "ranges": [("bench.update_fn", 7, 45.0, 115.0), ("bench.other", 7, 0.0, 200.0)],
        "launches": {1: (7, 0.0), 2: (7, 1.0), 3: (8, 50.0), 4: (7, 49.0), 5: (7, 119.0), 6: (7, 116.0)},
        "busy_s": 0.75, "window_s": 1.0, "steps": 2, "kv_lens": [10, 11],
        "cell": {"batch": 2}, "model": M, "window": {"seconds": 2.0, "flops": 989e12 * 0.5},
    }


def test_device_ops_per_step():
    assert reader("device_ops_per_step.decode")(canned()) == 3.0


def test_idle_shares():
    assert reader("idle_share.serve")(canned()) == pytest.approx(25.0)
    assert reader("idle_share.train")(canned()) == pytest.approx(25.0)
    assert reader("idle_share.train")(dict(canned(), busy_s=0.0)) is None


def test_mfu():
    # 0.5 s of peak work over a 2 s window
    assert reader("mfu.serve")(canned()) == pytest.approx(25.0)
    assert reader("mfu.train")(canned()) == pytest.approx(25.0)


def test_update_share():
    # launched on thread 7 inside [45, 115]: only correlation 4 (60 of 100 us);
    # 3 is inside the range's time but on thread 8, 6 and 2 on 7 but outside.
    assert reader("update_share.train")(canned()) == pytest.approx(60.0)
    assert reader("update_share.train")(dict(canned(), ranges=[])) is None


def test_decode_attention_roofline():
    # bytes 2 x 8 x (2 x 2 x 4 + 2 x 2 x 2 x kv): 1536 at kv 10, 1664 at 11,
    # over 3.35e12 B/s, against two launches of 1 us.
    got = reader("decode_attention_roofline")(canned())
    assert got == pytest.approx(100 * (1536 + 1664) / 3.35e12 / 2e-6)
    # a stretch that misses a launch reads nothing
    short = dict(canned(), device=canned()["device"][1:])
    assert reader("decode_attention_roofline")(short) is None


def test_record_from_a_chrome_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.stretch", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.update_fn", "ts": 40, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 10, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "k1", "ts": 60, "dur": 10, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 10, "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 8, "dur": 1, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 55, "dur": 1, "tid": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 4, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 50, "dur": 8, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 49, "dur": 10, "tid": 1},
        {"ph": "i", "cat": "marker", "name": "x", "ts": 1},
    ]
    r = record_from_events(ev)
    assert [d[0] for d in r["device"]] == ["k1", "k2", "k1"]
    assert r["stretch"] == (0.0, 100.0)
    assert r["ranges"] == [("bench.update_fn", 1, 40.0, 70.0)]
    assert r["launches"][3] == (1, 55.0)
    # busy [10, 35] and [60, 70]
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["breakdown"]["device_ops"] == [["k1", pytest.approx(30e-6)], ["k2", pytest.approx(10e-6)]]
    # gaps: [0, 10] before k1 (launched inside aten::add), [35, 60] before the
    # copy (inside aten::copy_, the innermost op), [70, 100] at the end.
    assert r["breakdown"]["idle_gaps"] == [["host", pytest.approx(30e-6)], ["aten::copy_", pytest.approx(25e-6)],
                                           ["aten::add", pytest.approx(10e-6)]]
