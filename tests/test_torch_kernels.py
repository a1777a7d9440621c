"""The port's kernels on the CPU: their plain versions against the JAX oracles
and the Pallas kernels (interpret mode), on the shapes of test_kernels.py.

On a CPU tensor each kernel wrapper returns its plain version, so these tests
hold the port's arithmetic, shapes, layouts and masks; the CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import layers as tlayers

# As TOL in tests/test_kernels.py.  fp32: the two frameworks sum the dot
# products and softmax in different orders.  bf16: the output is rounded to
# bf16 (one ulp is 2^-8 relative), and an fp32 difference in the last place
# can land on either side of a rounding boundary.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The JAX side jitted: one compile per shape instead of one per op.
j_flash_ref = jax.jit(
    jref.flash_attention_ref, static_argnames=("causal", "window", "softcap", "kv_len")
)
j_decode_ref = jax.jit(jref.decode_attention_ref)
j_rmsnorm_ref = jax.jit(jref.rmsnorm_ref)
j_sdpa = jax.jit(jlayers.sdpa, static_argnames=("causal",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tensors here are tiny: torch's CPU thread pool costs more than it
    # saves (over 100x on a shared machine), so run them on one thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same numpy input as a JAX and a torch array of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _qkv(seed, b, hq, hkv, lq, lk, d, dtype):
    q = _normal(seed, b, hq, lq, d)
    k = _normal(seed + 1, b, hkv, lk, d)
    v = _normal(seed + 2, b, hkv, lk, d)
    return [_both(a, dtype) for a in (q, k, v)]


class TestFlashAttention:
    @pytest.mark.parametrize(
        "b,hq,hkv,lq,lk,d",
        [
            (1, 2, 2, 128, 128, 64),  # MHA
            (2, 4, 2, 128, 128, 64),  # GQA 2:1
            (1, 8, 1, 128, 256, 128),  # MQA, rectangular
            (1, 3, 1, 192, 192, 192),  # odd heads, head_dim 192
        ],
    )
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_sweep(self, b, hq, hkv, lq, lk, d, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(0, b, hq, hkv, lq, lk, d, dtype)
        got = flash_attention(tq, tk, tv, causal=True)
        _close(got, j_flash_ref(jq, jk, jv, causal=True), TOL[dtype])
        if dtype == "float32" and (hq, hkv) == (4, 2):  # interpret mode is slow: one case
            pal = pallas_flash(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
            _close(got, pal, TOL[dtype])

    @pytest.mark.parametrize(
        "kw",
        [{"window": 32}, {"window": 64}, {"window": 100}, {"softcap": 20.0},
         {"softcap": 50.0}, {"causal": False}, {"kv_len": 77}],
        ids=["window32", "window64", "window100", "softcap20", "softcap50",
             "non_causal", "kv_len77"],
    )
    def test_masks_and_softcap(self, kw):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 2, 2, 64, 128, 64, "float32")
        kw = {"causal": True, **kw}
        got = flash_attention(tq, tk, tv, **kw)
        _close(got, j_flash_ref(jq, jk, jv, **kw), 2e-5)
        if kw.get("window") == 100 or kw.get("softcap") == 20.0:
            pal = pallas_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
            _close(got, pal, 2e-5)

    @pytest.mark.parametrize("lq,off", [(1, 40), (7, 13), (16, 0), (24, 9)])
    def test_q_offset_matches_layers_sdpa(self, lq, off):
        # A prefill of lq rows over a cache already holding `off` rows: the
        # port's q_offset against the reference sdpa's q_offset/kv_valid.
        b, hq, hkv, m, d = 2, 4, 2, 64, 16
        q = _normal(2, b, lq, hq, d)
        k = _normal(3, b, m, hkv, d)
        v = _normal(4, b, m, hkv, d)
        k[:, off + lq :] = 1e9  # rows past kv_len must not leak
        v[:, off + lq :] = 1e9
        want = j_sdpa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            q_offset=off, kv_valid=off + lq,
        )
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=off, kv_len=off + lq)
        _close(got, want, 2e-5)
        # lengths as int32 scalars on the device, as the model passes them
        got2 = ops.flash_attention(
            tq, tk, tv, causal=True,
            q_offset=torch.tensor(off, dtype=torch.int32),
            kv_len=torch.tensor(off + lq, dtype=torch.int32),
        )
        _close(got2, want, 2e-5)

    def test_model_layout_strided_equals_contiguous(self):
        # ops.* hand the kernels transposed views of [B, L, H, d] tensors.
        q = _normal(5, 2, 64, 4, 64)
        k = _normal(6, 2, 96, 2, 64)
        v = _normal(7, 2, 96, 2, 64)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        out = ops.flash_attention(tq, tk, tv, causal=True, kv_len=80)
        assert out.shape == tq.shape
        want = j_flash_ref(
            *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
            causal=True, kv_len=80,
        ).transpose(0, 2, 1, 3)
        _close(out, want, 2e-5)
        contig = flash_attention(
            *(t.transpose(1, 2).contiguous() for t in (tq, tk, tv)), causal=True, kv_len=80
        )
        _close(out, contig.transpose(1, 2).numpy(), 1e-6)


class TestDecodeAttention:
    @pytest.mark.parametrize(
        "b,hq,hkv,lk,d,kv_len",
        [
            (2, 4, 2, 256, 64, 200),
            (1, 8, 8, 512, 128, 512),
            (4, 2, 1, 128, 64, 1),
            (1, 14, 2, 256, 64, 100),  # GQA 7:1
        ],
    )
    def test_sweep(self, b, hq, hkv, lk, d, kv_len):
        (jq, tq) = _both(_normal(8, b, hq, d), "float32")
        (jk, tk) = _both(_normal(9, b, hkv, lk, d), "float32")
        (jv, tv) = _both(_normal(10, b, hkv, lk, d), "float32")
        got = decode_attention(tq, tk, tv, kv_len)
        _close(got, j_decode_ref(jq, jk, jv, kv_len), 2e-5)
        if hq // hkv == 7:
            _close(got, pallas_decode(jq, jk, jv, kv_len, block_k=64, interpret=True), 2e-5)

    def test_poisoned_tail_ignored(self):
        q, k, v = _normal(11, 1, 2, 64), _normal(12, 1, 2, 128, 64), _normal(13, 1, 2, 128, 64)
        k2, v2 = k.copy(), v.copy()
        k2[:, :, 64:] = 1e9
        v2[:, :, 64:] = 1e9
        kv = torch.tensor(64, dtype=torch.int32)
        clean = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv)
        poisoned = decode_attention(*(torch.from_numpy(a) for a in (q, k2, v2)), kv)
        np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), atol=1e-6)
        pal = pallas_decode(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2), 64,
                            block_k=32, interpret=True)
        _close(poisoned, pal, 2e-5)

    def test_model_layout(self):
        # ops.decode_attention reads the [B, M, Hkv, d] cache through a view.
        q = _normal(14, 2, 1, 6, 64)
        cache_k = _normal(15, 2, 48, 2, 64)
        cache_v = _normal(16, 2, 48, 2, 64)
        got = ops.decode_attention(
            torch.from_numpy(q), torch.from_numpy(cache_k), torch.from_numpy(cache_v),
            torch.tensor(30, dtype=torch.int32),
        )
        assert got.shape == (2, 1, 6, 64)
        want = j_decode_ref(
            jnp.asarray(q[:, 0]), jnp.asarray(cache_k).transpose(0, 2, 1, 3),
            jnp.asarray(cache_v).transpose(0, 2, 1, 3), 30,
        )
        _close(got[:, 0], want, 2e-5)


class TestRMSNorm:
    # The last three: the data plane's d 256, a d of 125 bf16 16-byte pieces
    # (a part-idle last round of the kernel's loads) and llama3.2-3b's 3072.
    @pytest.mark.parametrize(
        "shape,d",
        [((7, 64), 64), ((2, 33, 128), 128), ((256, 512), 512),
         ((2, 5, 256), 256), ((3, 7, 1000), 1000), ((2, 4, 3072), 3072)],
    )
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep(self, shape, d, dtype):
        jx, tx = _both(_normal(17, *shape), dtype)
        jw, tw = _both(_normal(18, d) * 0.1, dtype)
        got = rmsnorm(tx, tw)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _close(got, j_rmsnorm_ref(jx, jw), TOL[dtype])
        if len(shape) == 3:
            _close(got, pallas_rmsnorm(jx, jw, block_rows=32, interpret=True), TOL[dtype])

    def test_row_padding_path(self):
        # 5 rows: the Pallas kernel pads to a block multiple; the port's
        # grid covers the rows exactly and pads nothing.
        x = _normal(19, 5, 64)
        got = rmsnorm(torch.from_numpy(x), torch.zeros(64))
        want = pallas_rmsnorm(jnp.asarray(x), jnp.zeros((64,)), block_rows=4, interpret=True)
        _close(got, want, 1e-6)


    def test_out_view_is_written_in_place(self):
        # A row-strided output view: written, returned, and nothing past d.
        x = torch.from_numpy(_normal(20, 6, 64))
        buf = torch.full((6, 72), 7.0)
        got = rmsnorm(x, torch.zeros(64), out=buf[:, :64])
        assert got.data_ptr() == buf.data_ptr()
        _close(buf[:, :64], tref.rmsnorm_ref(x, torch.zeros(64)), 0.0)
        assert bool((buf[:, 64:] == 7.0).all())


ZOO_WIDTHS = (256, 768, 896, 1024, 2048, 3072, 4096, 4608, 6144, 8192)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ZOO_WIDTHS + (1001, 3))
def test_rmsnorm_plan(d, dtype, aligned):
    from repro_torch.kernels.rmsnorm import MAX_THREADS, VALUES, plan

    esize = dtype.itemsize
    # Misaligned: one element off 16 bytes in a pointer, or a row stride of
    # d + 1 elements.
    bits = 0 if aligned else (esize if d % 2 else (d + 1) * esize)
    p = plan(d, dtype, bits)
    ragged = d % (16 // esize) != 0
    assert p.vec == (1 if ragged or not aligned else 16 // esize)
    # The plan covers d exactly: every piece has one thread, and no round of
    # loads is idle for all the threads of a row.
    threads = 32 * p.warps
    assert d % p.vec == 0
    assert threads * (p.n - 1) < d // p.vec <= threads * p.n
    assert p.vec * p.n <= VALUES and threads * p.rows <= MAX_THREADS
    if d <= 1024:
        assert p.warps == 1 and p.rows == 4  # a warp a row, several rows a block
    elif p.vec > 1:
        assert 8 <= p.vec * p.n  # a group of warps a row, 8-32 values a thread
    assert plan(d, dtype, 16 * 12345 + bits) == p  # only the low 4 bits count


def test_rmsnorm_plan_limits():
    from repro_torch.kernels.rmsnorm import MAX_D, plan

    assert plan(MAX_D, torch.float32).warps == 8
    for d in (0, MAX_D + 1):
        with pytest.raises(ValueError, match="0 < d"):
            plan(d, torch.bfloat16)


def test_launch_counts_untouched_by_plain_versions():
    ops.reset_launch_counts()
    rmsnorm(torch.ones(2, 64), torch.zeros(64))
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0}


def test_kernel_switch_on_cpu_tensor_raises():
    x = torch.ones(2, 64)
    prev = tlayers.get_attn_impl()
    tlayers.set_attn_impl("kernel")
    try:
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            tlayers.rms_norm(x, torch.zeros(64))
        q = torch.ones(1, 4, 2, 16)
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            tlayers.sdpa(q, q, q, causal=True)
    finally:
        tlayers.set_attn_impl(prev)


@pytest.mark.parametrize("which", ["rmsnorm", "flash_attention", "decode_attention"])
def test_wrappers_reject_other_devices(which):
    # Neither CPU nor CUDA: no silent fallback to the plain version.
    m = torch.empty(2, 4, 8, 64, device="meta")
    call = {
        "rmsnorm": lambda: rmsnorm(m, torch.empty(64, device="meta")),
        "flash_attention": lambda: flash_attention(m, m, m),
        "decode_attention": lambda: decode_attention(m[:, :, 0], m, m, 8),
    }[which]
    with pytest.raises(ValueError, match="cpu or cuda"):
        call()


def test_ref_q_offset_zero_is_reference():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(20, 1, 2, 1, 32, 48, 64, "float32")
    got = tref.flash_attention_ref(tq, tk, tv, causal=True, kv_len=40, q_offset=0)
    _close(got, j_flash_ref(jq, jk, jv, causal=True, kv_len=40), 2e-5)


@pytest.mark.parametrize(
    "g,kv_len",
    [(g, kv) for g in (1, 3, 7) for kv in (0, 1, 63, 64, 65, 256)]
    + [(3, 100)],  # splits 2 and 3 of 4 hold no live key
    ids=lambda x: str(x),
)
def test_decode_split_merge_rule(g, kv_len):
    # The decode kernel's split over the cache (chunk 64 keys, 4 splits of a
    # 256-row cache) and its merge, against the TPU kernel in interpret mode
    # and the reference, in fp32.
    chunk, lk, d = 64, 256, 64
    q = _normal(30 + g, 2, 2 * g, d)
    k = _normal(31, 2, 2, lk, d)
    v = _normal(32, 2, 2, lk, d)
    got = tref.decode_attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)), kv_len, chunk)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, pallas_decode(jq, jk, jv, kv_len, block_k=chunk, interpret=True), 2e-5)
    if kv_len == 0:
        # No live key: the kernels give 0; the reference's plain softmax
        # would average every row instead.
        assert not got.any()
    else:
        _close(got, j_decode_ref(jq, jk, jv, kv_len), 2e-5)


def test_split_chunk_rule():
    from repro_torch.kernels.decode_attention import TILE, split_chunk

    assert split_chunk(2048, 4, 8) == 256  # 8 splits: 256 blocks, two a SM
    assert split_chunk(160, 4, 8) == 64  # the serving cache: 3 splits
    assert split_chunk(64, 4, 8) >= 64  # one split
    for lk, b, hkv in [(1, 1, 1), (100, 1, 1), (4096, 2, 8), (32768, 1, 8), (160, 16, 8)]:
        c = split_chunk(lk, b, hkv)
        splits = -(-lk // c)
        assert c % TILE == 0 and c >= TILE
        assert splits == 1 or b * hkv * splits <= 2 * 132 + b * hkv


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    # An edited header must change the library's path, so a stale build is
    # never loaded; so must the compiler flags.
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.lib_path(n) for n in _build.KERNELS}
    assert before == {n: _build.lib_path(n) for n in _build.KERNELS}
    (csrc / "sm90.cuh").write_text((csrc / "sm90.cuh").read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.KERNELS}
    assert all(after[n] != before[n] for n in _build.KERNELS)
    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert all(_build.lib_path(n) != after[n] for n in _build.KERNELS)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.lib_path("rmsnorm") != before["rmsnorm"]
