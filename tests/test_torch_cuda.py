"""The port on a CUDA card: the CUDA kernels against their plain versions,
and the torch target on the card against the same run on the CPU.

The grouped-GEMM and attention kernels are held to their plain versions
over sweeps with ragged edges (capacity, T, F and D off the tile; tq < tk
and tq > tk under a causal mask; ``-1`` tail pages, page ids past the
pool, seq_len 0), each call checked to take the route its wrapper
documents (the TMA kernels for aligned bf16, the tiled kernels for
float32 and for bf16 that TMA cannot address): float32 at ``tests/test_kernels.py``'s tolerances
(``1e-3`` GEMM, ``2e-3`` attention), bfloat16 at ``2e-2`` for attention
and ``rtol=1e-2, atol=1e-2 * max|want|`` for the GEMM, because the two
sides sum in other orders and round p and the output to bfloat16.

The SSM scans' kernels (RWKV-6 and Mamba, forward by each route and
backward) are held to their plain loops on the card in float32 and
bfloat16 at T = 1, at odd T and across Mamba's 32-step staging chunks,
from a carried state.  The step routes and Mamba's decode route keep the
loops' roundings: the last state within ``1e-6`` (bitwise unless ``exp``
differs; decode bitwise, state and y), outputs at
``SCAN_TOL`` (another order of the read-out's float32 sum: float32
``1e-5``, bfloat16 one bf16 ulp, ``2**-7``), and the gradients of all
six inputs, given both cotangents, against autograd through the plain
loop at ``SCAN_GRAD_TOL`` of the largest (float32 ``1e-4``; bfloat16
``2**-3``, because autograd rounds every step's gradient terms to
bfloat16 where the kernels sum them in float32), and in bfloat16 also
against the loop in float32 on the same values at ``2**-6``.  The
chunked (RWKV-6) and chunk (Mamba) routes round otherwise by design (TF32
products; ``ex2``-based exponentials, Δ·u and the read-out's state
unrounded): their state and y
are held to the loop run in float32 on the same bf16 values, no further
from it than the bf16 loop's own, at odd T, one and 64 heads, every head
width and three decay regimes.  Launches are counted by route, and a
CUDA tensor never reaches the plain loop.  The chunked backward routes
(RWKV-6 ``chunked``, Mamba ``chunk``) are held to their plain chunked
versions (``ref.rwkv6_scan_bwd_chunked``, ``ref.mamba_scan_bwd_chunked``:
the same float32 algebra, bf16 gradients within ``SCAN_TOL``, float32
ones within 1e-4 of the largest) and through autograd to the loop in bf16
and in float32, at T across the chunk of 16 and the unit of 64, one to
64 heads, every head width, three decay regimes, with and without a
cotangent of the last state; backward launches are counted by route, no
plain version is reached, and a chunked backward allocates at most a
sixteenth of the step pair's workspace beyond its outputs.

Every test needs a CUDA device and skips without one (``cuda`` marker).
The file imports neither jax nor ``repro``, so it runs where only the
port is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import codegen
from repro_torch.bench_irregular import ALL
from repro_torch.core import pipeline
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ragged_matmul import ragged_matmul
from repro_torch.kernels.spec_gather import spec_gather, spec_gather_staged
from repro_torch.kernels.spec_scatter import (spec_scatter_add,
                                              spec_scatter_add_staged)
from repro_torch.kernels import staging
from repro_torch.kernels.staging import Ring

pytestmark = pytest.mark.cuda

#: float32 scatter-add: atomics sum duplicates in a run-dependent order
#: (tests/test_kernels.py's float32 scatter tolerance)
SCATTER_ATOL = 1e-4


#: float32 tolerances of tests/test_kernels.py (rtol = atol)
GEMM_TOL, ATTN_TOL = 1e-3, 2e-3
#: bfloat16: another summation order, p and the output rounded to bf16
BF16_ATTN_TOL, BF16_GEMM_RTOL = 2e-2, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' float32 products in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rows, d, n, dtype, seed=7):
    rng = np.random.default_rng(seed)
    # -3..-1 poison, in range, and up to 4 past the last row (clip)
    idx = rng.integers(-3, rows + 4, n).astype(np.int32)
    if dtype == np.int32:
        tab = rng.integers(-2 ** 31, 2 ** 31, (rows, d),
                           dtype=np.int64).astype(np.int32)
        val = rng.integers(-2 ** 31, 2 ** 31, (n, d),
                           dtype=np.int64).astype(np.int32)
    else:
        tab = rng.normal(size=(rows, d)).astype(np.float32)
        val = rng.normal(size=(n, d)).astype(np.float32)
    return tab, idx, val


@pytest.mark.parametrize("rows,d,n", [(1, 1, 1), (8, 1, 37), (61, 7, 100),
                                      (16, 128, 24), (64, 3, 0),
                                      (65536, 1, 512), (40, 1, 4099)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_cuda_kernels_match_plain(cuda, rows, d, n, dtype):
    t, i, v = (torch.from_numpy(x).to(cuda)
               for x in _inputs(rows, d, n, dtype))
    g0, s0 = spec_gather.launches, spec_scatter_add.launches
    got = spec_gather(t, i)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spec_gather(t, i))
    got = spec_scatter_add(t.clone(), i, v)
    torch.cuda.synchronize()
    want = ref.spec_scatter_add(t.clone(), i, v)
    if dtype == np.int32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=SCATTER_ATOL)
    launched = int(n > 0)
    assert (spec_gather.launches - g0, spec_scatter_add.launches - s0) == \
        (launched, launched)


@pytest.mark.parametrize("cu_mode", ["vector", "state-machine"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_cuda_run_matches_cpu_and_counts_launches(cuda, name, cu_mode):
    case = ALL[name]()
    comp = pipeline.compile_spec(case.fn, case.decoupled)
    runs = {}
    for device in ("cpu", "cuda"):
        mem = {k: v.copy() for k, v in case.memory.items()}
        g0, s0 = spec_gather.launches, spec_scatter_add.launches
        r = codegen.run(comp, mem, case.params, target="torch",
                        device=device, cu_mode=cu_mode)
        runs[device] = (r, mem, (spec_gather.launches - g0,
                                 spec_scatter_add.launches - s0))
    (rc, mc, lc), (rp, mp, _) = runs["cuda"], runs["cpu"]
    for k in mp:
        assert np.array_equal(mp[k], mc[k]), k
    assert rc.target_used == "torch" and rc.cu_mode == cu_mode
    assert rc.stats == rp.stats
    assert lc == (rc.stats["gather_calls"], rc.stats["scatter_calls"])
    assert lc[0] > 0 and lc[1] > 0


#: the staged route's edge cases, as in tests/test_torch_staging.py:
#: (rows, n, kind) with n off a multiple of 4 (the 16-byte loads' tail),
#: n = 0, every request poisoned, indices past the last row, duplicate
#: destinations, n past a new slot (growth)
STAGED_CASES = [(61, 37, "mixed"), (61, 4, "mixed"), (61, 1, "mixed"),
                (61, 0, "mixed"), (61, 6, "mixed"), (8, 5, "poison"),
                (8, 4096, "poison"), (3, 23, "dups"), (7, 4099, "dups"),
                (65536, 512, "mixed"), (1 << 20, 4096, "mixed"),
                (40, 1030, "mixed")]


def _staged_inputs(rows, n, kind, seed=11):
    rng = np.random.default_rng(seed + rows + n)
    if kind == "poison":
        idx = np.full(n, -1, np.int32)
    elif kind == "dups":
        idx = rng.integers(-1, min(rows, 3), n).astype(np.int32)
    else:
        idx = rng.integers(-3, rows + 4, n).astype(np.int32)
    tab = rng.integers(-2 ** 31, 2 ** 31, (rows, 1),
                       dtype=np.int64).astype(np.int32)
    val = rng.integers(-2 ** 31, 2 ** 31, (n, 1),
                       dtype=np.int64).astype(np.int32)
    return tab, idx, val


def _stage(ring, idx, val):
    n = len(idx)
    slot = ring.acquire(n)
    slot.idx[:n] = idx
    slot.val[:n] = val[:, 0]
    return slot


def _route_counts():
    return (dict(spec_gather.route_launches),
            dict(spec_scatter_add.route_launches))


@pytest.mark.parametrize("rows,n,kind", STAGED_CASES)
def test_cuda_staged_matches_plain(cuda, rows, n, kind):
    tab, idx, val = _staged_inputs(rows, n, kind)
    t = torch.from_numpy(tab).to(cuda)
    ring = Ring(cuda)
    slot = _stage(ring, idx, val)
    (g0, s0), l0 = _route_counts(), (spec_gather.launches,
                                     spec_scatter_add.launches)
    # the values are on the host when the call returns: no synchronize
    got = spec_gather_staged(t, slot, n).copy()
    ti, tv = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    np.testing.assert_array_equal(got, ref.spec_gather(t, ti)[:, 0].cpu())
    out = spec_scatter_add_staged(t, slot, n)
    assert out is t
    torch.cuda.synchronize()
    want = ref.spec_scatter_add(torch.from_numpy(tab).to(cuda), ti, tv)
    assert torch.equal(t, want)
    launched = int(n > 0)
    g1, s1 = _route_counts()
    assert (g1["staged"] - g0["staged"], s1["staged"] - s0["staged"]) == \
        (launched, launched)
    assert (g1["tensor"], s1["tensor"]) == (g0["tensor"], s0["tensor"])
    assert (spec_gather.launches - l0[0], spec_scatter_add.launches - l0[1]) \
        == (launched, launched)
    ring.drain()


def test_cuda_staging_takes_only_page_locked_memory(cuda):
    ring = Ring(cuda)
    for slot in ring.slots:
        assert slot.idx_ptr and slot.val_ptr and slot.out_ptr
        assert slot.event_ptr and slot.stream is not None
    # pageable host memory has no device address
    pageable = np.zeros(64, np.int32)
    with pytest.raises(RuntimeError, match="page-locked"):
        staging.device_ptr(pageable.ctypes.data)


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_cuda_staged_scatters_back_to_back(cuda, slots):
    """Scatters with no gather between them: each refills a slot that an
    earlier scatter may still be reading, so the ring must wait for that
    scatter's event first.  Large requests on a small table make each
    kernel long enough for an early overwrite to show."""
    rng = np.random.default_rng(5)
    rows, n, calls = 97, 1 << 18, 12
    tab = rng.integers(-1000, 1000, (rows, 1)).astype(np.int32)
    t = torch.from_numpy(tab).to(cuda)
    want = torch.from_numpy(tab.astype(np.int64))
    ring = Ring(cuda, slots=slots, capacity=n)
    for k in range(calls):
        idx = rng.integers(-1, rows + 2, n).astype(np.int32)
        val = np.full((n, 1), k + 1, np.int32)
        spec_scatter_add_staged(t, _stage(ring, idx, val), n)
        live = idx >= 0
        np.add.at(want.numpy()[:, 0], np.minimum(idx[live], rows - 1), k + 1)
    torch.cuda.synchronize()
    assert torch.equal(t.cpu().long(), want)
    # a gather after them sees every scatter: its wait covers the stream
    slot = _stage(ring, np.arange(rows, dtype=np.int32),
                  np.zeros((rows, 1), np.int32))
    got = spec_gather_staged(t, slot, rows)
    np.testing.assert_array_equal(got, want.numpy()[:, 0])


@pytest.mark.parametrize("cu_mode", ["vector", "state-machine"])
def test_cuda_codegen_launches_only_by_the_staged_route(cuda, cu_mode):
    """A codegen run launches the spec kernels by the staged route only,
    once per gather and scatter call, bit-exact against the CPU run."""
    case = ALL["hist"](n=1 << 14, n_bins=1 << 10)
    comp = pipeline.compile_spec(case.fn, case.decoupled)
    runs = {}
    for device in ("cpu", "cuda"):
        mem = {k: v.copy() for k, v in case.memory.items()}
        before = _route_counts()
        r = codegen.run(comp, mem, case.params, target="torch",
                        device=device, cu_mode=cu_mode)
        after = _route_counts()
        runs[device] = (r, mem, [{k: a[k] - b[k] for k in a}
                                 for a, b in zip(after, before)])
    (rc, mc, (g, s)), (rp, mp, _) = runs["cuda"], runs["cpu"]
    for k in mp:
        assert np.array_equal(mp[k], mc[k]), k
    assert rc.target_used == "torch" and rc.cu_mode == cu_mode
    assert rc.stats == rp.stats
    assert g == {"tensor": 0, "staged": rc.stats["gather_calls"]}
    assert s == {"tensor": 0, "staged": rc.stats["scatter_calls"]}
    assert g["staged"] > 0 and s["staged"] > 0


def _dev(dev, dtype, *arrays):
    return [torch.from_numpy(a).to(dev).to(dtype) for a in arrays]


def _close(got, want, dtype, gemm=False):
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        tol = GEMM_TOL if gemm else ATTN_TOL
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    elif gemm:
        torch.testing.assert_close(
            got, want, rtol=BF16_GEMM_RTOL,
            atol=BF16_GEMM_RTOL * max(want.abs().max().item(), 1e-6))
    else:
        torch.testing.assert_close(got, want, rtol=BF16_ATTN_TOL,
                                   atol=BF16_ATTN_TOL)


def _route_delta(counter, before):
    return {r: counter.route_launches[r] - before[r] for r in before}


# the tma route's stages: 64 rows x 64 K of x, 64 K x 128/256 columns of
# w; capacity 56 (Kimi-K2's) and 200 (several 64-row tiles), D and F off
# those widths, and D or F not a multiple of 8 (tiled kernel in bf16)
@pytest.mark.parametrize("e,c,d,f", [(4, 64, 128, 256), (2, 128, 256, 128),
                                     (8, 32, 64, 64), (3, 56, 96, 200),
                                     (2, 13, 37, 45), (5, 70, 128, 136),
                                     (3, 56, 1024, 512), (3, 200, 264, 520),
                                     (2, 56, 100, 64), (2, 24, 64, 70),
                                     (1, 8, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ragged_matmul_matches_plain(cuda, e, c, d, f, dtype):
    rng = np.random.default_rng(e * c + d)
    x, w = _dev(cuda, dtype, rng.normal(size=(e * c, d)).astype(np.float32),
                rng.normal(size=(e, d, f)).astype(np.float32))
    n0 = ragged_matmul.launches
    r0 = dict(ragged_matmul.route_launches)
    got = ragged_matmul(x, w, capacity=c)
    torch.cuda.synchronize()
    assert ragged_matmul.launches == n0 + 1
    tma = dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
    assert _route_delta(ragged_matmul, r0) == {"tma": int(tma),
                                               "tiled": int(not tma)}
    _close(got, ref.ragged_matmul(x, w, c), dtype, gemm=True)


# T off the tma route's 128-row query tile and key stage, tq < tk and
# tq > tk, d 64 and 128, B*H = 140 past the 132 SMs of an H100
@pytest.mark.parametrize("b,h,tq,tk,d", [(2, 3, 256, 256, 64),
                                         (1, 2, 128, 128, 128),
                                         (1, 1, 100, 100, 64),
                                         (1, 2, 50, 130, 128),
                                         (1, 2, 130, 50, 64),
                                         (2, 1, 1, 77, 128),
                                         (1, 3, 300, 300, 128),
                                         (1, 2, 200, 333, 64),
                                         (1, 2, 333, 200, 128),
                                         (2, 70, 200, 200, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, b, h, tq, tk, d, causal,
                                            dtype):
    rng = np.random.default_rng(tq * tk + d)
    q, k, v = _dev(cuda, dtype,
                   *(rng.normal(size=(b, h, t, d)).astype(np.float32)
                     for t in (tq, tk, tk)))
    n0 = flash_attention.launches
    r0 = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    tma = dtype == torch.bfloat16
    assert _route_delta(flash_attention, r0) == {"tma": int(tma),
                                                 "tiled": int(not tma)}
    _close(got, ref.flash_attention(q, k, v, causal=causal), dtype)
    if causal and tq > tk:  # rows with no live key are exactly zero
        assert not got[:, :, :tq - tk].any()


def _unaligned(dev, shape, rng):
    """A contiguous bf16 tensor whose first element is 2 bytes off a
    16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32))
    return flat.to(dev).to(torch.bfloat16)[1:].view(*shape)


def test_cuda_unaligned_bf16_takes_the_tiled_kernels(cuda):
    """bf16 that TMA cannot address stays on the tiled kernels, right."""
    rng = np.random.default_rng(5)
    x = _unaligned(cuda, (2 * 64, 64), rng)
    (w,) = _dev(cuda, torch.bfloat16,
                rng.normal(size=(2, 64, 128)).astype(np.float32))
    r0 = dict(ragged_matmul.route_launches)
    got = ragged_matmul(x, w, capacity=64)
    torch.cuda.synchronize()
    assert _route_delta(ragged_matmul, r0) == {"tma": 0, "tiled": 1}
    _close(got, ref.ragged_matmul(x, w, 64), torch.bfloat16, gemm=True)
    q = _unaligned(cuda, (1, 2, 100, 64), rng)
    k, v = _dev(cuda, torch.bfloat16,
                *(rng.normal(size=(1, 2, 100, 64)).astype(np.float32)
                  for _ in range(2)))
    r0 = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _route_delta(flash_attention, r0) == {"tma": 0, "tiled": 1}
    _close(got, ref.flash_attention(q, k, v), torch.bfloat16)


def _paged_inputs(b, h, d, p, page, nmax, seed):
    """Seeded paged-cache inputs with every edge the kernel must take:
    seq_len 0, ``-1`` tail pages, a page id past the pool, a row whose
    pages are all ``-1``, a full row."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(p, page, h, d)).astype(np.float32)
    vp = rng.normal(size=(p, page, h, d)).astype(np.float32)
    pt = rng.integers(0, p, (b, nmax)).astype(np.int32)
    seq = rng.integers(1, page * nmax + 1, b).astype(np.int32)
    used = (seq + page - 1) // page
    for i in range(b):
        pt[i, used[i]:] = -1
    if b > 1:
        seq[0] = 0                  # no live slot
        pt[1, 0] = p + 3            # clips to the last page
    if b > 2:
        pt[2] = -1                  # every page poisoned
    if b > 3:
        seq[3] = page * nmax        # full row
        pt[3] = rng.integers(0, p, nmax)
    return q, kp, vp, pt, seq


@pytest.mark.parametrize("b,h,d,p,page,nmax", [(3, 4, 64, 16, 8, 5),
                                               (1, 8, 128, 8, 16, 3),
                                               (2, 2, 64, 32, 8, 8),
                                               (5, 8, 128, 64, 16, 40),
                                               (4, 3, 128, 9, 8, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain(cuda, b, h, d, p, page, nmax,
                                            dtype):
    q, kp, vp, pt, seq = _paged_inputs(b, h, d, p, page, nmax, seed=b + nmax)
    q, kp, vp = _dev(cuda, dtype, q, kp, vp)
    pt, seq = (torch.from_numpy(a).to(cuda) for a in (pt, seq))
    n0 = paged_attention.launches
    got = paged_attention(q, kp, vp, pt, seq)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    _close(got, ref.paged_attention(q, kp, vp, pt, seq), dtype)
    if b > 1:
        assert not got[0].any()    # seq_len 0: zeros
    if b > 2:
        assert not got[2].any()    # every page -1: zeros


def test_cuda_ops_reach_the_kernels(cuda):
    """The public API launches each kernel once per call."""
    rng = np.random.default_rng(3)
    x, w = _dev(cuda, torch.bfloat16,
                rng.normal(size=(2 * 24, 64)).astype(np.float32),
                rng.normal(size=(2, 64, 32)).astype(np.float32))
    q, k, v = _dev(cuda, torch.float32,
                   *(rng.normal(size=(1, 2, 40, 64)).astype(np.float32)
                     for _ in range(3)))
    pq, kp, vp, pt, seq = _paged_inputs(3, 4, 64, 16, 8, 5, seed=3)
    pq, kp, vp = _dev(cuda, torch.float32, pq, kp, vp)
    pt, seq = (torch.from_numpy(a).to(cuda) for a in (pt, seq))
    tab = torch.arange(8, dtype=torch.int32, device=cuda)[:, None]
    idx = torch.tensor([1, -1, 9], dtype=torch.int32, device=cuda)
    counters = (spec_gather, spec_scatter_add, ragged_matmul,
                flash_attention, paged_attention)
    before = [c.launches for c in counters]
    ops.spec_gather(tab, idx)
    ops.spec_scatter_add(tab.clone(), idx, torch.ones_like(idx)[:, None])
    got = [ops.ragged_matmul(x, w, 24), ops.flash_attention(q, k, v),
           ops.paged_attention(pq, kp, vp, pt, seq)]
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1] * 5
    _close(got[0], ref.ragged_matmul(x, w, 24), torch.bfloat16, gemm=True)
    _close(got[1], ref.flash_attention(q, k, v), torch.float32)
    _close(got[2], ref.paged_attention(pq, kp, vp, pt, seq), torch.float32)


# ---------------------------------------------------------------------------
# bf16 spec kernels (the MoE dispatch) and the serving engine
# ---------------------------------------------------------------------------


def _bf16_on(dev, rng, *shape, offset=False):
    """Seeded bf16 on the card; ``offset`` puts the base 2 bytes past a
    16-byte boundary (the gather's narrower copies, the scatter's single
    atomics)."""
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if not offset:
        return a.to(dev).bfloat16()
    buf = torch.empty(a.numel() + 1, dtype=torch.bfloat16, device=dev)
    out = buf[1:].view(shape)
    out.copy_(a)
    return out


#: (rows, d, n): d odd and even, n = 0, the MoE widths (7168, 64 requests
#: into 384 x 8 slots at decode)
BF16_CASES = [(1, 1, 1), (61, 7, 100), (384, 8, 37), (16, 128, 24),
              (40, 33, 0), (3072, 7168, 64), (3000, 130, 4099)]


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("rows,d,n", BF16_CASES)
def test_cuda_bf16_gather_matches_plain_bitwise(cuda, rows, d, n, offset):
    rng = np.random.default_rng(rows + d + n)
    # -3..-1 poison, in range, and up to 4 past the last row (clip)
    idx = torch.from_numpy(rng.integers(-3, rows + 4, n).astype(
        np.int32)).to(cuda)
    table = _bf16_on(cuda, rng, rows, d, offset=offset)
    e0 = spec_gather.entry_launches["spec_gather_bf16"]
    got = spec_gather(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spec_gather(table, idx))
    assert not got[idx < 0].any()  # poisoned rows are zeros
    if n:
        assert torch.equal(got[idx >= rows], table[-1].expand(
            int((idx >= rows).sum()), d))  # past the table: the last row
    assert spec_gather.entry_launches["spec_gather_bf16"] - e0 == int(n > 0)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("rows,d,n", BF16_CASES)
def test_cuda_bf16_scatter_matches_plain(cuda, rows, d, n, offset):
    """Unique destinations into a zero table (the MoE fill) bitwise;
    duplicates, poison and clipped indices within bf16_sum_bound of the
    float32 sum."""
    rng = np.random.default_rng(rows + d + n + 1)
    vals = _bf16_on(cuda, rng, n, d, offset=offset)
    uniq = torch.from_numpy(rng.permutation(max(rows, n))[:n].astype(
        np.int32)).to(cuda)
    uniq[::3] = -1
    zero = torch.zeros((max(rows, n), d), dtype=torch.bfloat16, device=cuda)
    e0 = spec_scatter_add.entry_launches["spec_scatter_add_bf16"]
    got = spec_scatter_add(zero.clone(), uniq, vals)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spec_scatter_add(zero.clone(), uniq, vals))
    assert spec_scatter_add.entry_launches["spec_scatter_add_bf16"] - e0 \
        == int(n > 0)

    idx = torch.from_numpy(rng.integers(-3, rows + 4, n).astype(
        np.int32)).to(cuda)
    table = _bf16_on(cuda, rng, rows, d, offset=offset)
    want = ref.spec_scatter_add(table.float(), idx, vals.float())
    bound = ref.bf16_sum_bound(table, idx, vals)
    got = spec_scatter_add(table.clone(), idx, vals).float()
    torch.cuda.synchronize()
    assert ((got - want).abs() <= bound).all()


def test_cuda_bf16_reaches_the_kernel_or_raises(cuda):
    """A bf16 CUDA tensor goes to the bf16 entry; the staged route takes
    no bf16 table."""
    t = torch.zeros((8, 4), dtype=torch.bfloat16, device=cuda)
    i = torch.tensor([1, -1, 9], dtype=torch.int32, device=cuda)
    before = (spec_gather.route_launches["tensor"],
              spec_gather.entry_launches["spec_gather_bf16"])
    spec_gather(t, i)
    assert (spec_gather.route_launches["tensor"],
            spec_gather.entry_launches["spec_gather_bf16"]) == \
        (before[0] + 1, before[1] + 1)
    ring = Ring(cuda, slots=1)
    with pytest.raises(TypeError):
        spec_gather_staged(t[:, :1].contiguous(), ring.acquire(2), 2)
    ring.drain()


def test_cuda_engine_matches_cpu(cuda):
    """One small float32 engine run on the card commits the tokens and
    poison counts of the same run on the CPU, its MoE dispatch through the
    float32 kernels."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import base
    from repro_torch.serve.engine import Engine, Request
    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 7, 4)]
    params = Engine(cfg, slots=3, max_len=24, device="cpu").params
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, tree_map(lambda t: t.to(dev), params), slots=3,
                     max_len=24, dispatch="spec-kernel", device=dev)
        g0 = spec_gather.entry_launches["spec_gather_f32"]
        res = eng.run([Request(rid=i, prompt=p, max_new=6)
                       for i, p in enumerate(prompts)])
        runs[dev] = (res, [(w.moe_poison, w.moe_requests)
                           for w in eng.wave_stats],
                     spec_gather.entry_launches["spec_gather_f32"] - g0)
    assert runs["cuda"][:2] == runs["cpu"][:2]
    assert runs["cpu"][2] == 0
    # two waves: (1 prefill + 6 decode steps) x 2 moe layers each
    assert runs["cuda"][2] == 2 * 7 * cfg.n_layers


@pytest.mark.parametrize("case", ["zero", "bf16-integer", "bf16-normal"])
def test_cuda_route_ties_match_stable_argsort(cuda, case):
    """The router's top-k on the card puts the lower expert first among
    equal probabilities: its experts equal a numpy stable argsort of the
    card's own probabilities, at Kimi-K2's router width (d_model 7168,
    384 experts, top-8) where bf16 logits tie often."""
    from repro_torch.models import moe
    d, e, k = 7168, 384, 8
    gen = torch.Generator(device="cpu").manual_seed(11)
    if case == "zero":
        x = torch.randn(4096, 64, generator=gen)
        router = torch.zeros(64, e)
    elif case == "bf16-integer":
        x = torch.randint(-3, 4, (1024, d), generator=gen).bfloat16()
        router = (torch.randint(-4, 5, (d, e), generator=gen) / 256
                  ).bfloat16()
    else:
        x = torch.randn(4096, d, generator=gen).bfloat16()
        router = (torch.randn(d, e, generator=gen) * 0.02).bfloat16()
    probs, gates, experts = moe._route({"router": router.to(cuda)},
                                       x.to(cuda), k)
    assert probs.is_cuda and experts.is_cuda
    p = probs.cpu().numpy()
    want = np.argsort(-p, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(experts.cpu().numpy(), want)
    np.testing.assert_array_equal(gates.cpu().numpy(),
                                  np.take_along_axis(p, want, axis=1))
    top = -np.sort(-p, axis=1)[:, :k + 1]
    assert (np.diff(top, axis=1) == 0).any(axis=1).sum() > 0
    if case == "zero":
        assert (want == np.arange(k)).all()


def test_cuda_warm_cached_compile_runs_bitwise(cuda, tmp_path):
    """A warm compile-cache object runs on the card bitwise equal to the
    sequential interpreter, through the staged kernels."""
    from repro_torch.bench_irregular import join
    from repro_torch.core import interp
    from repro_torch.frontend import CompileCache
    cc = CompileCache(str(tmp_path))
    case = ALL["join"]()
    assert join.program().compile(case.decoupled, cache=cc, verify=True
                                  ).cache_stats["outcome"] == "cold"
    warm = join.program().compile(case.decoupled, cache=cc, verify=True)
    assert warm.cache_stats["outcome"] == "warm"
    want = {k: v.copy() for k, v in case.memory.items()}
    interp.run(case.fn, want, case.params)
    for cu_mode in ("vector", "state-machine"):
        mem = {k: v.copy() for k, v in case.memory.items()}
        g0 = spec_gather.launches
        r = codegen.run(warm, mem, case.params, target="torch",
                        device=cuda, cu_mode=cu_mode)
        torch.cuda.synchronize()
        assert r.cache["outcome"] == "warm" and r.cu_mode == cu_mode
        assert spec_gather.launches > g0
        for k in want:
            assert np.array_equal(mem[k], want[k]), (cu_mode, k)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b",
                                  "llama_3_2_vision_90b", "whisper_medium"])
def test_cuda_family_matches_cpu(cuda, arch):
    """The smoke config (float32) of each family of the seventh slice:
    prefill (left-padded, with stub memory where the family takes it) and
    greedy decode steps on the card commit the CPU's tokens, logits within
    1e-4; the SSM states within the same."""
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs import base
    from repro_torch.models.model import build_model
    cfg = base.smoke(base.get(arch))
    m = build_model(cfg, "spec-kernel")
    params = m.init(torch.Generator().manual_seed(5), "cpu")
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (3, 9)).astype(
        np.int32))
    pads = torch.tensor([0, 3, 5], dtype=torch.int32)
    mem = None
    if cfg.family in ("vlm", "encdec"):
        s = cfg.enc_len if cfg.family == "encdec" else cfg.n_patches
        mem = torch.from_numpy(rng.standard_normal(
            (3, s, cfg.d_model)).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        md = None if mem is None else mem.to(dev)
        logits, cache = m.prefill(p, tok.to(dev), 16, memory=md,
                                  pad_lens=pads.to(dev))
        dec = m._encode(p, md) if cfg.family == "encdec" else md
        out, toks = [logits], []
        for step in range(4):
            toks.append(logits.argmax(-1)[:, None].to(torch.int32))
            logits, cache = m.decode_step(p, cache, toks[-1], 9 + step,
                                          memory=dec, pad_lens=pads.to(dev))
            out.append(logits)
        runs[str(dev)] = ([x.cpu() for x in out], torch.cat(toks, 1).cpu(),
                          [t.cpu() for t in tree_leaves(cache[1] or [])])
    cpu, card = runs["cpu"], runs["cuda"]
    assert torch.equal(cpu[1], card[1])
    for a, b in zip(cpu[0] + cpu[2], card[0] + card[2], strict=True):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_cuda_jamba_wave_spec_kernel_matches_spec(cuda):
    """A Jamba smoke wave in bf16 (8 requests, 16 new tokens, a capacity
    that poisons): dispatch="spec-kernel" commits the tokens and poison
    counts of "spec", launching each bf16 entry 4 x 17 = 68 times (4 MoE
    sublayers, 1 prefill + 16 decode steps)."""
    import dataclasses
    from repro_torch.configs import base
    from repro_torch.serve.engine import Engine, Request
    cfg = dataclasses.replace(base.smoke(base.get("jamba_1_5_large_398b")),
                              dtype="bfloat16", capacity_factor=0.5)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in rng.integers(4, 13, 8)]
    params = Engine(cfg, slots=8, max_len=40, device=cuda).params
    runs = {}
    for dispatch in ("spec-kernel", "spec"):
        eng = Engine(cfg, params, slots=8, max_len=40, dispatch=dispatch,
                     device=cuda)
        g0 = spec_gather.entry_launches["spec_gather_bf16"]
        s0 = spec_scatter_add.entry_launches["spec_scatter_add_bf16"]
        res = eng.run([Request(rid=i, prompt=p, max_new=16)
                       for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        runs[dispatch] = (res, [(w.moe_poison, w.moe_requests)
                                for w in eng.wave_stats],
                          spec_gather.entry_launches["spec_gather_bf16"] - g0,
                          spec_scatter_add.entry_launches[
                              "spec_scatter_add_bf16"] - s0)
    assert runs["spec-kernel"][:2] == runs["spec"][:2]
    assert runs["spec-kernel"][1][0][0] > 0, "no capacity race"
    assert runs["spec-kernel"][2:] == (68, 68)
    assert runs["spec"][2:] == (0, 0)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "kimi_k2_1t_a32b",
                                  "jamba_1_5_large_398b", "rwkv6_7b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """Three steps of ``make_train_step`` on the card and on the CPU from
    the same float32 smoke weights and batches: losses at rtol 1e-4,
    every parameter and moment within 1e-4, the step count equal."""
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_train_step
    cfg = base.smoke(base.get(arch))
    init, step_fn, _ = make_train_step(build_model(cfg), peak_lr=1e-3,
                                       warmup=1, total=10)
    state0 = init(torch.Generator().manual_seed(3), "cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2))
    runs = {}
    for dev in ("cpu", cuda):
        state = tree_map(lambda t: t.to(dev, copy=True)
                         if torch.is_tensor(t) else t, state0)
        losses = []
        for i in range(3):
            state, m = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                       for k, v in data.batch_at(i).items()})
            losses.append(float(m["loss"]))
        runs[str(dev)] = (losses, [t.cpu() for t in tree_leaves(state)
                                   if torch.is_tensor(t)])
    cpu, card = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    for a, b in zip(cpu[1], card[1], strict=True):
        assert a.dtype == b.dtype
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)


def test_cuda_kernels_refuse_a_gradient(cuda):
    """Each kernel entry (and its ops wrapper) raises NotImplementedError
    on CUDA tensors that require a gradient, before it launches; without
    a gradient the same call launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_matmul import ragged_matmul

    def f(*shape):
        return torch.randn(shape, device=cuda)

    i32 = dict(dtype=torch.int32, device=cuda)
    idx = torch.tensor([0, 3, -1], **i32)
    cases = [
        (spec_gather, ops.spec_gather, lambda: [f(16, 8), idx], [0]),
        (spec_scatter_add, ops.spec_scatter_add,
         lambda: [f(16, 8), idx, f(3, 8)], [0, 2]),
        (ragged_matmul, lambda x, w: ops.ragged_matmul(x, w, 8),
         lambda: [f(16, 64), f(2, 64, 64)], [0, 1]),
        (flash_attention, ops.flash_attention,
         lambda: [f(1, 2, 16, 64), f(1, 2, 16, 64), f(1, 2, 16, 64)],
         [0, 1, 2]),
        (paged_attention, ops.paged_attention,
         lambda: [f(2, 2, 64), f(4, 8, 2, 64), f(4, 8, 2, 64),
                  torch.tensor([[0, 1], [2, 3]], **i32),
                  torch.tensor([10, 5], **i32)], [0, 1, 2]),
    ]
    for kernel, op, make, diff in cases:
        for i in diff:
            args = make()
            args[i].requires_grad_(True)
            n = kernel.launches
            with pytest.raises(NotImplementedError, match="no backward"):
                op(*args)
            assert kernel.launches == n
            with torch.no_grad():
                op(*args)
            assert kernel.launches == n + 1
    torch.cuda.synchronize()


def test_cuda_spec_kernel_loss_refuses_a_gradient(cuda):
    from repro_torch.configs import base
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad
    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    model = build_model(cfg, "spec-kernel")
    params = model.init(torch.Generator(device=cuda).manual_seed(2), cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16),
                                     dtype=torch.int32, device=cuda)}
    n = spec_scatter_add.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        value_and_grad(model, params, batch)
    assert spec_scatter_add.launches == n
    assert not any(p.requires_grad for p in
                   [params["embed"], params["lm_head"]])


def test_cuda_checkpoint_roundtrip_bf16(cuda, tmp_path):
    """A bf16 TrainState on the card through save_async, wait and restore
    with a shard_fn onto the card: every tensor back on the card, in its
    dtype, bitwise; a fresh trainer restores LATEST and continues."""
    import dataclasses
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs import base
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = dataclasses.replace(base.smoke(base.get("granite_34b")),
                              dtype="bfloat16")
    kw = dict(ckpt_dir=str(tmp_path), global_batch=2, seq_len=16)
    out = train(cfg, TrainerConfig(steps=2, **kw), log=lambda s: None)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, out["state"])
    mgr.wait()
    back = mgr.restore(shard_fn=lambda t: tree_map(
        lambda x: x.to(cuda) if torch.is_tensor(x) else x, t))
    saved = [t for t in tree_leaves(out["state"]) if torch.is_tensor(t)]
    got = [t for t in tree_leaves(back) if torch.is_tensor(t)]
    assert len(saved) == len(got)
    assert any(t.dtype == torch.bfloat16 for t in got)
    for a, b in zip(saved, got):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    logs = []
    out2 = train(cfg, TrainerConfig(steps=4, **kw), log=logs.append)
    assert logs[0].startswith("[trainer] restored step 2")
    assert int(out2["state"].step) == 4
    assert out2["state"].params["embed"].device.type == "cuda"


def _mesh_moe(cuda, e=16, d=256, ff=128, seed=5):
    """A small bf16 MoE layer on the card: (params, x, kwargs)."""
    from repro_torch.configs import base
    from repro_torch.models.model import init_sublayer
    import dataclasses
    cfg = dataclasses.replace(base.smoke(base.get("kimi_k2_1t_a32b")),
                              n_experts=e, top_k=4, d_model=d, moe_d_ff=ff,
                              n_shared_experts=1, dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = init_sublayer(cfg, "moe", gen, cuda)
    x = torch.randn((256, d), generator=gen, device=cuda).bfloat16()
    return p, x, dict(n_experts=e, top_k=4)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", ["ep", "tp"])
def test_cuda_mesh_local_functions_sum_to_flat(cuda, variant, n, cf):
    """The expert- and tensor-parallel local functions of ``n`` model
    shards, run in turn on the card through the bf16 kernels and summed,
    against the flat path: the poisoned count bitwise, the output within
    2**-6 max|flat| (each shard's partial is rounded to bf16 before the
    sum), one scatter a shard, and one gather a shard (EP) or one in all
    (TP)."""
    from repro_torch.models import moe
    p, x, kw = _mesh_moe(cuda)
    flat, n_flat = moe._moe_spec_flat(p, x, capacity_factor=cf,
                                      kernel=True, stats=True, **kw)
    g0, s0 = spec_gather.launches, spec_scatter_add.launches
    out, pois, slots = moe.run_shards(p, x, n, variant=variant,
                                      capacity_factor=cf, kernel=True, **kw)
    torch.cuda.synchronize()
    assert spec_scatter_add.launches - s0 == n
    assert spec_gather.launches - g0 == (n if variant == "ep" else 1)
    assert int(pois) == int(n_flat)
    if cf == 0.5:
        assert int(n_flat) > 0
    dev = (out.float() - flat.float()).abs().max().item()
    assert dev <= 2.0 ** -6 * flat.float().abs().max().item()
    if variant == "ep":
        live = torch.stack([s >= 0 for s in slots])
        assert int(live.sum(0).max()) <= 1          # one home shard
        assert int(live.sum()) == x.shape[0] * kw["top_k"] - int(n_flat)


def test_cuda_mesh_11_nccl_matches_flat(cuda):
    """``moe_spec`` under ``use_mesh`` of a (1, 1) mesh on a one-rank
    NCCL group: the expert-parallel variant through the bf16 kernels
    gives the flat path's output bitwise and its poison count."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import process_group
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh
    p, x, kw = _mesh_moe(cuda, seed=6)
    flat, n_flat = moe._moe_spec_flat(p, x, capacity_factor=0.5,
                                      kernel=True, stats=True, **kw)
    with process_group("nccl"):
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        g0 = spec_gather.entry_launches["spec_gather_bf16"]
        with use_mesh(mesh):
            out, pois = moe.moe_spec(p, x, capacity_factor=0.5, kernel=True,
                                     stats=True, **kw)
        torch.cuda.synchronize()
        assert spec_gather.entry_launches["spec_gather_bf16"] - g0 == 1
    assert int(pois) == int(n_flat) > 0
    assert torch.equal(out, flat)


# ---------------------------------------------------------------------------
# the SSM scans
# ---------------------------------------------------------------------------

#: outputs against the plain loop: rtol, and atol as a share of max|want|
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: gradients against autograd through the plain loop: atol as a share of
#: max|want|
SCAN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -3}
#: bf16 gradients against autograd through the loop in float32 on the
#: same values, as a share of max|want|
SCAN_GRAD_F32_TOL = 2.0 ** -6


def _scan_case(kind, dev, dtype, b, t, width, seed=31, heads=2):
    """Seeded inputs of one scan on ``dev``: RWKV-6 with ``heads`` heads
    of ``width``, Mamba with ``width`` channels and N = 16."""
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype).to(dev)

    if kind == "rwkv":
        h = heads
        w = torch.sigmoid(torch.randn((b, t, h, width), generator=g) + 2)
        return [f(b, t, h, width, scale=0.5), f(b, t, h, width, scale=0.5),
                f(b, t, h, width), w.to(dtype).to(dev),
                f(h, width, scale=0.5),
                (torch.randn((b, h, width, width), generator=g) * 0.3
                 ).to(dev)]
    delta = torch.nn.functional.softplus(torch.randn((b, t, 1), generator=g))
    return [f(b, t, width), delta.to(dtype).to(dev), f(b, t, 16),
            f(b, t, 16), -torch.exp(torch.randn((width, 16), generator=g)
                                    * 0.5).to(dev),
            (torch.randn((b, width, 16), generator=g) * 0.3).to(dev)]


SCAN_CASES = [("rwkv", 64, 1), ("rwkv", 64, 37), ("rwkv", 16, 9),
              ("rwkv", 32, 2), ("mamba", 300, 1), ("mamba", 300, 33),
              ("mamba", 128, 70)]


def _scan_fns(kind):
    from repro_torch.kernels import scan
    return ((scan.rwkv6_scan, ref.rwkv6_scan, scan.rwkv6_plan)
            if kind == "rwkv" else
            (scan.mamba_scan, ref.mamba_scan, scan.mamba_plan))


def _no_worse_than_bf16_loop(got, args, plain):
    """A route that rounds otherwise than the loop, held to the loop run
    in float32 on the same values: state and y finite, each no further
    from it than the bf16 loop's own."""
    want = plain(*[a.float() for a in args])
    loop = plain(*args)
    for g, w, lp, what in zip(got, want, loop, ("state", "y")):
        assert torch.isfinite(g.float()).all(), what
        err = (g.float() - w).abs().max().item()
        own = (lp.float() - w).abs().max().item()
        assert err <= own, (what, err, own)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,width,t", SCAN_CASES)
def test_cuda_scan_forward_matches_plain(cuda, kind, width, t, dtype):
    """The step and decode routes keep the loop's roundings: the state
    within 1e-6 (bitwise unless exp differs), y at SCAN_TOL; the chunked
    and chunk routes (bf16, T >= 2) are held to the float32 loop."""
    fn, plain, plan = _scan_fns(kind)
    args = _scan_case(kind, cuda, dtype, 3, t, width)
    route = plan(*args)
    n0, r0 = fn.launches, fn.route_launches[route]
    s, y = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and fn.route_launches[route] == r0 + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    if route in ("chunked", "chunk"):
        _no_worse_than_bf16_loop((s, y), args, plain)
        return
    ws, wy = plain(*args)
    torch.testing.assert_close(s, ws, rtol=1e-6, atol=1e-6)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol,
                               atol=tol * wy.float().abs().max().item())


def _regime(args, kind, regime, g):
    """The scan's decays in one regime: the models' own (as made), near 0
    (RWKV w <= 1e-3 with a fifth exactly 0; Mamba delta a <= -20) or near
    1 (w >= 0.999; delta a >= -1e-3)."""
    if regime == "model":
        return args
    dev, dtype = args[0].device, args[0].dtype
    if kind == "rwkv":
        shape = args[3].shape
        if regime == "near0":
            w = torch.rand(shape, generator=g) * 1e-3
            w[..., ::5] = 0.0
        else:
            w = 1 - torch.rand(shape, generator=g) * 1e-3
        args[3] = w.to(dtype).to(dev)
        return args
    d = args[4].shape[0]
    if regime == "near0":
        delta = torch.nn.functional.softplus(
            torch.randn(args[1].shape, generator=g)) + 2
        a = -(10 + 5 * torch.rand((d, 16), generator=g))
    else:
        delta = torch.rand(args[1].shape, generator=g) * 1e-4
        a = -(1 + 9 * torch.rand((d, 16), generator=g))
    args[1], args[4] = delta.to(dtype).to(dev), a.to(dev)
    return args


#: the new routes' cases: (kind, heads or channels, head width, T)
ROUTE_CASES = [("rwkv", 1, 16, 3), ("rwkv", 64, 16, 33), ("rwkv", 1, 32, 77),
               ("rwkv", 64, 32, 17), ("rwkv", 1, 64, 65),
               ("rwkv", 64, 64, 129), ("mamba", 512, 16, 3),
               ("mamba", 1024, 16, 77), ("mamba", 2056, 16, 33)]


@pytest.mark.parametrize("regime", ["model", "near0", "near1"])
@pytest.mark.parametrize("kind,n,hd,t", ROUTE_CASES)
def test_cuda_scan_new_routes_no_worse_than_bf16_loop(cuda, kind, n, hd, t,
                                                      regime):
    """The chunked (RWKV-6) and chunk (Mamba) routes at odd T, H in {1,
    64}, every head width, three decay regimes: finite, and no further
    from the loop in float32 than the bf16 loop is."""
    fn, plain, plan = _scan_fns(kind)
    g = torch.Generator().manual_seed(40 + t)
    if kind == "rwkv":
        args = _scan_case(kind, cuda, torch.bfloat16, 2, t, hd, heads=n)
    else:
        args = _scan_case(kind, cuda, torch.bfloat16, 2, t, n)
    args = _regime(args, kind, regime, g)
    route = plan(*args)
    assert route == ("chunked" if kind == "rwkv" else "chunk")
    r0 = fn.route_launches[route]
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.route_launches[route] == r0 + 1
    _no_worse_than_bf16_loop(got, args, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [300, 8192])
def test_cuda_mamba_decode_is_bitwise_the_loop(cuda, width, dtype):
    """The decode route's state is the loop's bit for bit, and its y the
    step kernel's (the same sum in the same order; the loop's read-out is
    a matmul that sums in its own order, held at SCAN_TOL)."""
    from repro_torch.kernels import scan
    args = _scan_case("mamba", cuda, dtype, 8, 1, width)
    assert scan.mamba_plan(*args) == "decode"
    s, y = scan.mamba_scan(*args)
    ws, wy = ref.mamba_scan(*args)
    ss, ys = scan.mamba_scan_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(s, ws) and torch.equal(s, ss)
    assert torch.equal(y, ys)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol,
                               atol=tol * wy.float().abs().max().item())


def test_cuda_scan_launches_by_route(cuda):
    """Each call counts one launch, on the route its plan names."""
    from repro_torch.kernels import scan
    cases = [("rwkv", torch.bfloat16, 5, "chunked"),
             ("rwkv", torch.bfloat16, 1, "step"),
             ("rwkv", torch.float32, 5, "step"),
             ("mamba", torch.bfloat16, 5, "chunk"),
             ("mamba", torch.float32, 1, "decode"),
             ("mamba", torch.bfloat16, 1, "decode"),
             ("mamba", torch.float32, 5, "step")]
    for kind, dtype, t, route in cases:
        fn, _, _ = _scan_fns(kind)
        args = _scan_case(kind, cuda, dtype, 2, t, 64)
        before = dict(fn.route_launches)
        fn(*args)
        torch.cuda.synchronize()
        after = dict(fn.route_launches)
        before[route] += 1
        assert after == before, (kind, dtype, t, route)


def test_cuda_scan_never_reaches_the_loop(cuda, monkeypatch):
    """A CUDA tensor launches a route's kernel on every route: the plain
    loops, made to raise, are never called."""
    from repro_torch.kernels import scan

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain loop")

    monkeypatch.setattr(ref, "rwkv6_scan", refuse)
    monkeypatch.setattr(ref, "mamba_scan", refuse)
    for kind in ("rwkv", "mamba"):
        for dtype in (torch.float32, torch.bfloat16):
            for t in (1, 5):
                fn, _, _ = _scan_fns(kind)
                fn(*_scan_case(kind, cuda, dtype, 2, t, 64))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,width,t", SCAN_CASES)
def test_cuda_scan_backward_matches_autograd(cuda, kind, width, t, dtype):
    """The gradients of all six inputs, given the outputs' and the last
    state's cotangents, against autograd through the plain loop."""
    from repro_torch.kernels import scan
    fn, plain = ((scan.rwkv6_scan, ref.rwkv6_scan) if kind == "rwkv" else
                 (scan.mamba_scan, ref.mamba_scan))
    args = _scan_case(kind, cuda, dtype, 3, t, width)
    g = torch.Generator().manual_seed(32)
    grads = {}
    for name, f in (("kernel", fn), ("plain", plain)):
        xs = [a.clone().requires_grad_(True) for a in args]
        s, y = f(*xs)
        if name == "kernel":
            w_s = torch.randn(s.shape, generator=g).to(cuda)
            w_y = torch.randn(y.shape, generator=g).to(cuda)
        n0 = fn.bwd_launches
        ((y.float() * w_y).sum() + (s * w_s).sum()).backward()
        torch.cuda.synchronize()
        assert fn.bwd_launches == n0 + (name == "kernel")
        grads[name] = [x.grad for x in xs]
    if dtype == torch.bfloat16:
        # the loop in float32 on the same values: within SCAN_GRAD_F32_TOL
        xs = [a.float().requires_grad_(True) for a in args]
        s, y = plain(*xs)
        ((y * w_y).sum() + (s * w_s).sum()).backward()
        grads["float32"] = [x.grad for x in xs]
    for i, (got, want) in enumerate(zip(grads["kernel"], grads["plain"])):
        assert got.dtype == want.dtype, i
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= SCAN_GRAD_TOL[dtype] * scale, (i, err, scale)
        if dtype == torch.bfloat16:
            want = grads["float32"][i]
            err = (got.float() - want).abs().max().item()
            assert err <= SCAN_GRAD_F32_TOL * want.abs().max().item(), i


def test_cuda_scan_refuses_what_it_is_not_built_for(cuda):
    from repro_torch.kernels import scan
    args = _scan_case("rwkv", cuda, torch.float32, 2, 3, 8)
    with pytest.raises(ValueError, match="head dim"):
        scan.rwkv6_scan(*args)
    args = _scan_case("mamba", cuda, torch.float32, 2, 3, 64)
    args[2], args[3] = args[2][..., :8].contiguous(), \
        args[3][..., :8].contiguous()
    args[4], args[5] = args[4][:, :8].contiguous(), \
        args[5][..., :8].contiguous()
    with pytest.raises(ValueError, match="state dim"):
        scan.mamba_scan(*args)


# ---------------------------------------------------------------------------
# the SSM scans' chunked backward routes
# ---------------------------------------------------------------------------

#: the chunked backward routes' cases: (kind, heads or channels, head
#: width, T), T across the chunks (16) and the units (64) the routes keep
# the last of each kind is its main path's shape in chip_smoke.py's
# [train-ssm]: RWKV-6-7B's 64 heads of 64 at T = 1024, Jamba's smoke
# config's 64 Mamba channels at T = 64 (B = 2)
BWD_CASES = [("rwkv", 1, 16, 2), ("rwkv", 3, 16, 17), ("rwkv", 2, 32, 65),
             ("rwkv", 64, 64, 64), ("rwkv", 2, 64, 130),
             ("rwkv", 64, 64, 1024),
             ("mamba", 256, 16, 2), ("mamba", 264, 16, 65),
             ("mamba", 520, 16, 130), ("mamba", 64, 16, 64)]


def _bwd_fns(kind):
    from repro_torch.kernels import scan
    return ((scan.rwkv6_scan, ref.rwkv6_scan, scan.rwkv6_chunked_bwd,
             ref.rwkv6_scan_bwd_chunked, "chunked")
            if kind == "rwkv" else
            (scan.mamba_scan, ref.mamba_scan, scan.mamba_chunk_bwd,
             ref.mamba_scan_bwd_chunked, "chunk"))


def _bwd_case(cuda, kind, n, hd, t, regime, seed=50):
    g = torch.Generator().manual_seed(seed + t)
    if kind == "rwkv":
        args = _scan_case(kind, cuda, torch.bfloat16, 2, t, hd, heads=n)
    else:
        args = _scan_case(kind, cuda, torch.bfloat16, 2, t, n)
    return _regime(args, kind, regime, g), g


def _grads_through(fn, args, w_s, w_y, f32=False):
    xs = [(a.float() if f32 else a.clone()).requires_grad_(True)
          for a in args]
    s, y = fn(*xs)
    loss = (y.float() * w_y).sum()
    if w_s is not None:
        loss = loss + (s * w_s).sum()
    loss.backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("last_state", [True, False])
@pytest.mark.parametrize("regime", ["model", "near0", "near1"])
@pytest.mark.parametrize("kind,n,hd,t", BWD_CASES)
def test_cuda_scan_chunked_bwd_matches_plain(cuda, kind, n, hd, t, regime,
                                             last_state):
    """The chunked backward routes against their plain chunked versions
    (the same float32 algebra: bf16 gradients within SCAN_TOL, the
    float32 ones within 1e-4 of the max), and through autograd against
    the loop in bf16 (SCAN_GRAD_TOL) and in float32 on the same values
    (SCAN_GRAD_F32_TOL), with and without a cotangent of the last state;
    every gradient finite."""
    fn, plain, entry, plain_bwd, route = _bwd_fns(kind)
    args, g = _bwd_case(cuda, kind, n, hd, t, regime)
    s, y = plain(*args)
    w_s = torch.randn(s.shape, generator=g).to(cuda) if last_state else None
    w_y = torch.randn(y.shape, generator=g).to(cuda)
    dy = w_y.to(torch.bfloat16)
    got = entry(*args, w_s, dy)
    torch.cuda.synchronize()
    want = plain_bwd(*args, w_s, dy)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.isfinite(a.float()).all(), i
        tol = SCAN_TOL[torch.bfloat16] if a.dtype == torch.bfloat16 else 1e-4
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * scale + 1e-30, (i, err, scale)
    r0 = fn.bwd_route_launches[route]
    got = _grads_through(fn, args, w_s, w_y)
    torch.cuda.synchronize()
    assert fn.bwd_route_launches[route] == r0 + 1
    loop = _grads_through(plain, args, w_s, w_y)
    f32 = _grads_through(plain, args, w_s, w_y, f32=True)
    for i, (a, b, c) in enumerate(zip(got, loop, f32)):
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= SCAN_GRAD_TOL[torch.bfloat16] * b.float().abs().max(
        ).item() + 1e-30, (i, err)
        err = (a.float() - c).abs().max().item()
        assert err <= SCAN_GRAD_F32_TOL * c.abs().max().item() + 1e-30, (
            i, err)


def test_cuda_scan_bwd_launches_by_route(cuda):
    """Each backward counts one launch, on the route its plan names:
    bf16 prefill by the chunked routes; float32, T = 1, Mamba's ragged
    channels and an unaligned dy by the step pair."""
    from repro_torch.kernels import scan
    cases = [("rwkv", torch.bfloat16, 5, 64, "chunked"),
             ("rwkv", torch.bfloat16, 1, 64, "step"),
             ("rwkv", torch.float32, 5, 64, "step"),
             ("mamba", torch.bfloat16, 5, 64, "chunk"),
             ("mamba", torch.bfloat16, 1, 64, "step"),
             ("mamba", torch.bfloat16, 5, 300, "step"),
             ("mamba", torch.float32, 5, 64, "step")]
    for kind, dtype, t, width, route in cases:
        fn, _, _ = _scan_fns(kind)
        args = [a.requires_grad_(True) for a in
                _scan_case(kind, cuda, dtype, 2, t, width)]
        before = dict(fn.bwd_route_launches), fn.bwd_launches
        s, y = fn(*args)
        (y.float().sum() + s.sum()).backward()
        torch.cuda.synchronize()
        want = dict(before[0])
        want[route] += 1
        assert (dict(fn.bwd_route_launches), fn.bwd_launches) == (
            want, before[1] + 1), (kind, dtype, t, width, route)
    # an unaligned cotangent of y goes by the step pair
    for kind, route in (("rwkv", scan.rwkv6_scan_bwd),
                        ("mamba", scan.mamba_scan_bwd)):
        fn, _, _ = _scan_fns(kind)
        args = _scan_case(kind, cuda, torch.bfloat16, 2, 5, 64)
        s, y = fn(*args)
        flat = torch.empty(y.numel() + 1, dtype=y.dtype, device=cuda)
        dy = flat[1:].view(y.shape)
        dy.copy_(torch.randn(y.shape, device=cuda).to(y.dtype))
        before = fn.bwd_route_launches["step"]
        route(*args, None, dy)
        torch.cuda.synchronize()
        assert fn.bwd_route_launches["step"] == before + 1, kind


def test_cuda_scan_bwd_never_reaches_the_loop(cuda, monkeypatch):
    """A CUDA tensor's backward launches a route's kernel on every route:
    the plain loops and the plain chunked backward, made to raise, are
    never called."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("rwkv6_scan", "mamba_scan", "rwkv6_scan_bwd_chunked",
                 "mamba_scan_bwd_chunked"):
        monkeypatch.setattr(ref, name, refuse)
    for kind in ("rwkv", "mamba"):
        for dtype in (torch.float32, torch.bfloat16):
            for t in (1, 5, 70):
                fn, _, _ = _scan_fns(kind)
                xs = [a.requires_grad_(True) for a in
                      _scan_case(kind, cuda, dtype, 2, t, 64)]
                s, y = fn(*xs)
                (y.float().sum() + s.sum()).backward()
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_cuda_scan_chunked_bwd_workspace_under_bound(cuda, kind):
    """What one chunked backward allocates beyond its outputs stays under
    a sixteenth of the step pair's workspace (every step's float32
    state) on the same inputs."""
    from repro_torch.kernels import scan
    fn, _, entry, _, _ = _bwd_fns(kind)
    if kind == "rwkv":
        args = _scan_case(kind, cuda, torch.bfloat16, 2, 512, 64, heads=8)
        b, t, h, hd = args[0].shape
        step_ws = b * h * t * hd * hd * 4
    else:
        args = _scan_case(kind, cuda, torch.bfloat16, 2, 512, 1024)
        b, t, d = args[0].shape
        step_ws = b * t * d * 16 * 4
    s, y = fn(*args)
    dy = torch.randn(y.shape, device=cuda).to(y.dtype)
    ds = torch.randn(s.shape, device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = entry(*args, ds, dy)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = sum(o.numel() * o.element_size() for o in out)
    assert peak - kept <= step_ws / 16, (peak, kept, step_ws)
