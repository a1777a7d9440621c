"""On the card: the absorbed MLA decode kernel against its plain version at
the long-prompt cell's shape (batch 4, a cache of 32150 rows), at lengths
across its split and tile edges, and replayed from a CUDA graph at growing
lengths read from the device.

    python -m pytest bench/tests/test_bench_mla_card.py -q -m card

Run as a script it prints the kernel's time (L2 flushed, median of 25
launches) beside its bound and its plain version's, as ``PERF.md``'s table
of kernels has them:

    python3 bench/tests/test_bench_mla_card.py
"""

from __future__ import annotations

import math
import statistics
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

pytestmark = pytest.mark.card

B, H, M, LAT, ROPE = 4, 16, 32150, 512, 64
SCALE = 192**-0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
# bf16 inputs and output: the kernel's products are bf16 with P split into two
# bf16 halves and fp32 sums, so it parts from the fp32 plain version by the
# output's own rounding (2^-9 relative) and a little: 4e-3 relative L2 is
# twice the output's rounding; a kernel that drops the low half of P, reads
# a row twice or misses one reads ~1e-2 and beyond.
REL_L2 = 4e-3


def inputs(seed: int, b: int = B, h: int = H, m: int = M):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q_lat = torch.randn(b, h, LAT, generator=g, device="cuda").bfloat16()
    q_pe = torch.randn(b, h, ROPE, generator=g, device="cuda").bfloat16()
    buf = torch.randn(b, m, LAT + ROPE, generator=g, device="cuda").bfloat16()
    return q_lat, q_pe, buf[..., :LAT], buf[..., LAT:]


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture
def kernel(card):
    from repro_torch.kernels import mla_decode, ops, ref

    ops.build()
    return mla_decode, ref


def test_the_kernel_equals_its_plain_version_across_split_and_tile_edges(kernel):
    import torch

    mod, ref = kernel
    q_lat, q_pe, c_kv, k_pe = inputs(1)
    chunk = mod.split_chunk(M, B, torch.cuda.get_device_properties(0).multi_processor_count)
    for kv in (1, 31, 32, 33, chunk - 1, chunk, chunk + 1, 3 * chunk + 17, 32000, 32100, M - 1, M):
        got = mod.mla_decode(q_lat, q_pe, c_kv, k_pe, torch.tensor(kv, dtype=torch.int32, device="cuda"), SCALE)
        want = ref.mla_decode_ref(q_lat.float(), q_pe.float(), c_kv.float(), k_pe.float(), kv, SCALE)
        assert rel_l2(got, want) < REL_L2, kv
    # Rows past kv_len are never read: poisoned, the result holds.
    kv = 3 * chunk + 17
    want = mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv, SCALE)
    c_kv[:, kv:] = float("nan")
    k_pe[:, kv:] = float("inf")
    assert torch.equal(mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv, SCALE), want)


def test_fewer_heads_and_a_short_cache(kernel):
    import torch

    mod, ref = kernel
    q_lat, q_pe, c_kv, k_pe = inputs(2, b=3, h=5, m=40)
    for kv in (0, 1, 39, 40):
        got = mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv, SCALE)
        if kv == 0:
            assert torch.count_nonzero(got) == 0  # as the decode kernel: no row, no weight
            continue
        want = ref.mla_decode_ref(q_lat.float(), q_pe.float(), c_kv.float(), k_pe.float(), kv, SCALE)
        assert rel_l2(got, want) < REL_L2, kv


def test_replayed_from_a_graph_at_growing_lengths(kernel):
    import torch

    mod, ref = kernel
    q_lat, q_pe, c_kv, k_pe = inputs(3)
    kv_len = torch.tensor(32000, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, SCALE)  # warm: builds and loads before the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, SCALE)
    torch.cuda.current_stream().wait_stream(side)
    for kv in (32000, 32001, 32050, 32063, 32064, 32149, M):
        kv_len.fill_(kv)
        graph.replay()
        want = ref.mla_decode_ref(q_lat.float(), q_pe.float(), c_kv.float(), k_pe.float(), kv, SCALE)
        assert rel_l2(out, want) < REL_L2, kv
        assert torch.equal(out, mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv, SCALE)), kv


def times(kv: int = 32100, reps: int = 25) -> None:
    """Print the kernel's and its plain version's median time at the cell's
    shape, L2 flushed before each launch, beside the roofline's bound."""
    import torch

    from bench.counts import kernels, mla
    from repro_torch.kernels import mla_decode as mod
    from repro_torch.kernels import ops, ref

    ops.build()
    q_lat, q_pe, c_kv, k_pe = inputs(4)
    kv_len = torch.tensor(kv, dtype=torch.int32, device="cuda")
    # 512 MiB, past the 50 MB L2; zeroing it keeps the card busy while the host
    # enqueues the timed call, so the wrapper's host time is not timed.
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device="cuda")

    def median_us(fn) -> float:
        fn()
        ms = []
        for _ in range(reps):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms) * 1e3

    bound = kernels.least_seconds(mla.mla_decode_flops(B, H, kv), mla.mla_decode_bytes(B, H, kv)) * 1e6
    us = median_us(lambda: mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, SCALE))
    # Also back to back in one CUDA graph, as a replayed decode step runs it
    # (its 148 MB of rows outrun the L2 anyway).
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            mod.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, SCALE)
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    replayed = a.elapsed_time(b) * 1e3 / 20
    print(f"mla_decode: B{B} H{H} kv={kv} of {M}: {us:.2f} us, bound {bound:.2f} us (bytes), share "
          f"{100 * bound / us:.1f} %; in a graph, back to back: {replayed:.2f} us a call", flush=True)
    plain = median_us(lambda: ref.mla_decode_ref(q_lat, q_pe, c_kv, k_pe, kv_len, SCALE))
    print(f"mla_decode plain (ref.mla_decode_ref on bf16): {plain:.1f} us", flush=True)


if __name__ == "__main__":
    times()
