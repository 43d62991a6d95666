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
differs; decode bitwise, state and y; the float32 step entries' states
bitwise), outputs at
``SCAN_TOL`` (another order of the read-out's float32 sum: float32
``1e-5``, bfloat16 one bf16 ulp, ``2**-7``), and the gradients of all
six inputs, given both cotangents, against autograd through the plain
loop at ``SCAN_GRAD_TOL`` of the largest (float32 ``1e-4``; bfloat16
``2**-3``, because autograd rounds every step's gradient terms to
bfloat16 where the kernels sum them in float32), and in bfloat16 also
against the loop in float32 on the same values at ``2**-6``.  The
chunked (RWKV-6) and chunk (Mamba) routes round otherwise by design (TF32
products; ``ex2``-based exponentials, Δ·u and the read-out's state
unrounded): in bf16 their state and y
are held to the loop run in float32 on the same bf16 values, no further
from it than the bf16 loop's own, at odd T, one and 64 heads, every head
width and three decay regimes; in float32 (the routes float32 prefill
and training take since the float32 entries were added) the four
entries, forward and backward, are held to the float32 loop at its own
tolerances (state and y ``1e-5``, gradients ``1e-4`` of the largest) at
T = 2, 17 and 65 in the three regimes, with and without ``ds``.  Launches are counted by route, and a
CUDA tensor never reaches the plain loop.  The chunked backward routes
(RWKV-6 ``chunked``, Mamba ``chunk``) are held to their plain chunked
versions (``ref.rwkv6_scan_bwd_chunked``, ``ref.mamba_scan_bwd_chunked``:
the same float32 algebra, bf16 gradients within ``SCAN_TOL``, float32
ones within 1e-4 of the largest) and through autograd to the loop in bf16
and in float32, at T across the chunk of 16 and the unit of 64, one to
64 heads, every head width, three decay regimes, with and without a
cotangent of the last state; backward launches are counted by route, no
plain version is reached, and a chunked backward allocates at most a
sixteenth of the workspace of every step's state beyond its outputs.
The step backward pairs (T = 1, unaligned tensors, Mamba's ragged
widths) are held through their entries to autograd through the loop and
to their plain versions (``ref.rwkv6_scan_bwd_step``,
``ref.mamba_scan_bwd_step``) at T on and off their units and 2048, one
element off the 16-byte boundary, ragged Mamba widths, both dtypes, and
two runs of each are bitwise equal.  The step forwards (``-k step_fwd``)
are held through their entries the same way, aligned and one element off
the 16-byte boundary, T on and off their runs and 2048, both dtypes: the
last state the loop's bit for bit, y within ``SCAN_TOL`` of the loop's
and bit for bit the plain version that sums in the kernel's order
(``ref.rwkv6_scan_step`` at T >= 2, ``ref.mamba_scan_step``), and two runs
bitwise equal.

The chunked-attention kernels (the reference's loop over key chunks,
forward and backward) are held through autograd to the plain loop in
float32 and bfloat16 at every head width, causal and not, ``q_offset``
0 and 37, Tq from 1 to 1500 against Tk from 1 to 1500 with partial last
tiles: float32 within ``1e-5`` (output) and ``1e-4`` (gradients, of the
largest of the three) of max|want|; bfloat16 against the loop run in
float32 on the same values, no further from it than the bfloat16 loop
plus one bf16 ulp.  Launches are counted, a CUDA tensor never reaches
the loop, the backward is bitwise deterministic, and a head width or
dtype the kernels are not built for raises.  Each route is also
launched by itself (``tile``, ``split``, ``mma``, ``simt`` forward over
Tq in {1, 7, 64, 129, 1500} against Tk in {1, 9, 127, 128, 129, 513,
1500}, the log-sum-exp within 1e-4 of the float32 loop's; each backward
route from the output and log-sum-exp of each forward route), two runs
of every route are bitwise equal, the layer takes the planned routes,
and a route launched at a width it is not built for raises.  The tile
route at d 112 and 160 (whole 64-column chunks in shared memory) is
held forward and backward at two queries and at
Tq and Tk off every tile, and writes no column past d (outputs in
buffers poisoned past their end).  The ``head`` route (d 16, at most 64
queries and keys, one block a head) is held the same way through the
entry over Tq and Tk in {1, 2, 15, 16, 17, 24, 63, 64} in both dtypes,
its backward also from the ``mma`` / ``simt`` forward's log-sum-exp;
each way is one launch of one kernel (the profiler sees one kernel a
backward), and a call past its limits raises without launching any
route.

Every test needs a CUDA device and skips without one (``cuda`` marker).
The file imports neither jax nor ``repro``, so it runs where only the
port is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import itertools
import os

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


#: the narrow Kimi-K2-shaped model of the card's training step at d 112:
#: two layers of Kimi-K2's 64 heads of 112 (8 KV heads), two experts
#: routed top-2 (every token to both, so no routing choice can flip between
#: the card and the CPU), bf16; B and T of its batch (T past the split
#: route's one query: the tile route, forward and backward)
WIDE_KIMI = dict(n_layers=2, d_model=256, n_heads=64, n_kv_heads=8,
                 head_dim=112, n_experts=2, top_k=2, moe_d_ff=128,
                 d_ff=128, dtype="bfloat16")
WIDE_KIMI_BT = (2, 128)
#: the card's bf16 loss and gradients against the same step run in
#: float32 on the CPU on the same bf16 weights: no farther from it than
#: the CPU's bf16 step through the plain versions is, plus this share of
#: the largest (the kernels and cuBLAS sum in other orders than the CPU,
#: and each side rounds the activations to bf16 after its own sums)
WIDE_KIMI_TOL = 2.0 ** -6


def test_cuda_train_wide_head_step_matches_cpu(cuda):
    """One training step (loss and every gradient) of a narrow
    Kimi-K2-shaped model (:data:`WIDE_KIMI`) on the card through the tile
    route at d 112, forward and backward, held to the same step on the
    CPU through the plain versions (see :data:`WIDE_KIMI_TOL`)."""
    import dataclasses
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs import base
    from repro_torch.kernels import chunked_attention as ca
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad
    cfg = dataclasses.replace(base.smoke(base.get("kimi_k2_1t_a32b")),
                              **WIDE_KIMI)
    b, t = WIDE_KIMI_BT
    q = torch.zeros((b, cfg.n_heads, t, cfg.hd), dtype=torch.bfloat16,
                    device=cuda)
    assert ca.attn_plan(q, q, q, True) == "tile"
    assert ca.attn_bwd_plan(q, q, q, q, q, True) == "tile"
    model = build_model(cfg, "spec")
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (b, t)).astype(np.int32))
    fwd0 = dict(ca.chunked_attention.route_launches)
    bwd0 = dict(ca.chunked_attention.bwd_route_launches)
    card = value_and_grad(model, tree_map(lambda x: x.to(cuda), params),
                          {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    fwd = {r: n - fwd0[r]
           for r, n in ca.chunked_attention.route_launches.items()}
    bwd = {r: n - bwd0[r]
           for r, n in ca.chunked_attention.bwd_route_launches.items()}
    # the group checkpoint runs each forward twice
    assert fwd == {**dict.fromkeys(fwd, 0), "tile": 2 * cfg.n_layers}
    assert bwd == {**dict.fromkeys(bwd, 0), "tile": cfg.n_layers}
    cpu = value_and_grad(model, params, {"tokens": tokens})
    wide = value_and_grad(
        build_model(dataclasses.replace(cfg, dtype="float32"), "spec"),
        tree_map(lambda x: x.float() if x.is_floating_point() else x,
                 params), {"tokens": tokens})
    got, own, want = (float(r[0]) for r in (card, cpu, wide))
    assert abs(got - want) <= abs(own - want) + 2.0 ** -8 * abs(want), (
        got, own, want)
    leaves = [tree_leaves(r[1]) for r in (card, cpu, wide)]
    assert len(leaves[0]) == len(leaves[1]) == len(leaves[2])
    for i, (g, c, w) in enumerate(zip(*leaves)):
        assert g.dtype == c.dtype and g.shape == c.shape == w.shape, i
        g, c = g.cpu().float(), c.float()
        assert torch.isfinite(g).all(), i
        err = (g - w).abs().max().item()
        base_err = (c - w).abs().max().item()
        assert err <= base_err + WIDE_KIMI_TOL * w.abs().max().item(), (
            i, tuple(w.shape), err, base_err)


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
#: the last state against the plain loop: rtol, and atol as a share of
#: max|want| (chip_smoke.py's)
SCAN_STATE_TOL = 1e-5


def _f32_close(got, want, tol):
    """float32 ``got`` finite and within rtol ``tol``, atol ``tol *
    max|want|`` of ``want``."""
    assert got.dtype == want.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * want.abs().max().item())


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
    and chunk routes (T >= 2) are held to the float32 loop: in bf16 no
    further from it than the bf16 loop, in float32 at SCAN_STATE_TOL and
    SCAN_TOL."""
    fn, plain, plan = _scan_fns(kind)
    args = _scan_case(kind, cuda, dtype, 3, t, width)
    route = plan(*args)
    n0, r0 = fn.launches, fn.route_launches[route]
    s, y = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and fn.route_launches[route] == r0 + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    if route in ("chunked", "chunk") and dtype == torch.bfloat16:
        _no_worse_than_bf16_loop((s, y), args, plain)
        return
    ws, wy = plain(*args)
    if route in ("chunked", "chunk"):
        _f32_close(s, ws, SCAN_STATE_TOL)
        _f32_close(y, wy, SCAN_TOL[torch.float32])
        return
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
             ("rwkv", torch.float32, 5, "chunked"),
             ("rwkv", torch.float32, 1, "step"),
             ("mamba", torch.bfloat16, 5, "chunk"),
             ("mamba", torch.float32, 1, "decode"),
             ("mamba", torch.bfloat16, 1, "decode"),
             ("mamba", torch.float32, 5, "chunk")]
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
    prefill in either dtype by the chunked routes; T = 1, Mamba's ragged
    channels (300 in bf16, 30 in float32) and an unaligned dy by the step
    pair."""
    from repro_torch.kernels import scan
    cases = [("rwkv", torch.bfloat16, 5, 64, "chunked"),
             ("rwkv", torch.bfloat16, 1, 64, "step"),
             ("rwkv", torch.float32, 5, 64, "chunked"),
             ("rwkv", torch.float32, 1, 64, "step"),
             ("mamba", torch.bfloat16, 5, 64, "chunk"),
             ("mamba", torch.bfloat16, 1, 64, "step"),
             ("mamba", torch.bfloat16, 5, 300, "step"),
             ("mamba", torch.float32, 5, 64, "chunk"),
             ("mamba", torch.float32, 5, 300, "chunk"),
             ("mamba", torch.float32, 5, 30, "step")]
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
    for (kind, route), dtype in itertools.product(
            (("rwkv", scan.rwkv6_scan_bwd), ("mamba", scan.mamba_scan_bwd)),
            (torch.bfloat16, torch.float32)):
        fn, _, _ = _scan_fns(kind)
        args = _scan_case(kind, cuda, dtype, 2, 5, 64)
        s, y = fn(*args)
        flat = torch.empty(y.numel() + 1, dtype=y.dtype, device=cuda)
        dy = flat[1:].view(y.shape)
        dy.copy_(torch.randn(y.shape, device=cuda).to(y.dtype))
        before = fn.bwd_route_launches["step"]
        route(*args, None, dy)
        torch.cuda.synchronize()
        assert fn.bwd_route_launches["step"] == before + 1, (kind, dtype)


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
    a sixteenth of a workspace of every step's float32 state on the same
    inputs."""
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


# ---------------------------------------------------------------------------
# the SSM scans' step backward pairs
# ---------------------------------------------------------------------------

#: T on and off the pairs' units of 32 tokens
STEP_BWD_T = (1, 2, 15, 16, 17, 33, 64, 65)
#: (kind, heads or channels, head width): every head width; Mamba at
#: widths off the 16-byte vector in both dtypes (30), in bf16 only (36),
#: and past one block of 256 channels (300)
STEP_BWD_SHAPES = [("rwkv", 2, 16), ("rwkv", 3, 32), ("rwkv", 2, 64),
                   ("mamba", 30, 16), ("mamba", 36, 16), ("mamba", 300, 16)]


def _off(t):
    """``t`` moved one element off the 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _step_bwd_fns(kind):
    from repro_torch.kernels import scan
    return ((scan.rwkv6_scan, ref.rwkv6_scan, scan.rwkv6_step_bwd,
             ref.rwkv6_scan_bwd_step) if kind == "rwkv" else
            (scan.mamba_scan, ref.mamba_scan, scan.mamba_step_bwd,
             ref.mamba_scan_bwd_step))


def _step_bwd_check(cuda, kind, n, hd, t, dtype, offset, last, seed=70):
    """The step pair's entry on one case, twice: one launch each, bitwise
    the same; every gradient finite and within SCAN_GRAD_TOL of autograd
    through the loop in ``dtype`` (in bf16 also within SCAN_GRAD_F32_TOL
    of the loop in float32 on the same values, plus the bf16 loop's own
    distance from it: the pair keeps the bf16 loop's roundings), and
    within SCAN_TOL (bf16) or 1e-4 (float32) of the largest of the plain
    step backward's (the same algorithm, other orders of summation)."""
    fn, plain, entry, plain_bwd = _step_bwd_fns(kind)
    g = torch.Generator().manual_seed(seed + t + n)
    if kind == "rwkv":
        args = _scan_case(kind, cuda, dtype, 2, t, hd, seed=seed + t,
                          heads=n)
    else:
        args = _scan_case(kind, cuda, dtype, 2, t, n, seed=seed + t)
    if offset:
        args = [_off(a) for a in args]
    with torch.no_grad():
        s, y = plain(*args)
    w_s = torch.randn(s.shape, generator=g).to(cuda) if last else None
    w_y = torch.randn(y.shape, generator=g).to(cuda)
    dy = w_y.to(dtype)
    ds = w_s
    if offset:
        dy = _off(dy)
        ds = None if ds is None else _off(ds)
    n0 = fn.bwd_route_launches["step"]
    got = entry(*args, ds, dy)
    again = entry(*args, ds, dy)
    torch.cuda.synchronize()
    assert fn.bwd_route_launches["step"] == n0 + 2
    for i, (a, b) in enumerate(zip(got, again)):
        assert torch.equal(a, b), i
    want = plain_bwd(*args, ds, dy)
    loop = _grads_through(plain, args, w_s, w_y)
    f32 = (_grads_through(plain, args, w_s, w_y, f32=True)
           if dtype == torch.bfloat16 else None)
    for i, a in enumerate(got):
        b = torch.zeros_like(a) if loop[i] is None else loop[i]
        assert a.dtype == b.dtype == want[i].dtype and a.shape == b.shape, i
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= SCAN_GRAD_TOL[dtype] * b.float().abs().max().item() \
            + 1e-30, (i, err)
        tol = SCAN_TOL[torch.bfloat16] if a.dtype == torch.bfloat16 else 1e-4
        err = (a.float() - want[i].float()).abs().max().item()
        assert err <= tol * want[i].float().abs().max().item() + 1e-30, (
            i, err)
        if f32 is not None:
            c = torch.zeros_like(a, dtype=torch.float32) if f32[i] is None \
                else f32[i]
            own = (b.float() - c).abs().max().item()
            err = (a.float() - c).abs().max().item()
            assert err <= SCAN_GRAD_F32_TOL * c.abs().max().item() + own \
                + 1e-30, (i, err, own)


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", STEP_BWD_T)
@pytest.mark.parametrize("kind,n,hd", STEP_BWD_SHAPES)
def test_cuda_scan_step_bwd_matches_autograd(cuda, kind, n, hd, t, dtype,
                                             offset, last):
    """The step pairs (the backward of T = 1, unaligned tensors, Mamba's
    ragged widths) at T on and off their units, every head width, ragged
    Mamba widths, aligned and one element off the 16-byte boundary, with
    and without a cotangent of the last state: see ``_step_bwd_check``."""
    _step_bwd_check(cuda, kind, n, hd, t, dtype, offset, last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,n,hd", [("rwkv", 2, 64), ("mamba", 300, 16)])
def test_cuda_scan_step_bwd_long(cuda, kind, n, hd, dtype):
    """The step pairs at T = 2048 (64 units), unaligned: see
    ``_step_bwd_check``."""
    _step_bwd_check(cuda, kind, n, hd, 2048, dtype, True, True)


def test_cuda_scan_step_bwd_takes_unaligned_and_ragged_by_step(cuda):
    """Through autograd, what the chunked routes refuse launches the step
    pair: T = 1, an unaligned r or u, Mamba's D = 30 in float32 and D =
    36 in bf16."""
    for kind, dtype, t, width, which in (
            ("rwkv", torch.bfloat16, 1, 64, None),
            ("rwkv", torch.float32, 9, 64, 0),
            ("mamba", torch.float32, 9, 30, None),
            ("mamba", torch.bfloat16, 9, 36, None),
            ("mamba", torch.bfloat16, 9, 64, 0)):
        fn, _, _, _ = _step_bwd_fns(kind)
        args = _scan_case(kind, cuda, dtype, 2, t, width)
        if which is not None:
            args[which] = _off(args[which])
        xs = [a.requires_grad_(True) for a in args]
        before = dict(fn.bwd_route_launches)
        s, y = fn(*xs)
        (y.float().sum() + s.sum()).backward()
        torch.cuda.synchronize()
        before["step"] += 1
        assert dict(fn.bwd_route_launches) == before, (kind, dtype, t, width)
        assert all(torch.isfinite(x.grad.float()).all() for x in xs)


#: the Mamba step pair's float32 du at T = 1 against the loop in float64:
#: seeds of the sweep, in each decay regime; B, T and width of
#: chip_smoke.py's STEP_BWD_EDGES T = 1 case (Jamba's 8192 channels)
DU_F64_SEEDS = range(64)
DU_F64_SHAPE = (2, 1, 8192)
#: the margin past the float32 loop's own distance from float64, as a
#: share of max|du| (SCAN_GRAD_TOL's float32 share)
DU_F64_MARGIN = 1e-4


def _du_case(dev, regime, seed):
    """Seeded float32 Mamba inputs at :data:`DU_F64_SHAPE` in one decay
    regime, and seeded cotangents of the last state and of y."""
    b, t, width = DU_F64_SHAPE
    g = torch.Generator().manual_seed(seed + 50_000)
    args = _regime(_scan_case("mamba", dev, torch.float32, b, t, width,
                              seed=seed), "mamba", regime, g)
    w_s = torch.randn((b, width, 16), generator=g).to(dev)
    w_y = torch.randn((b, t, width), generator=g).to(dev)
    return args, w_s, w_y


def _du(fn, args, w_s, w_y):
    """du of ``fn``'s scan through autograd, given the cotangents of the
    last state (None: none) and of y, in the inputs' dtype."""
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    s, y = fn(*xs)
    outs, cots = ([s, y], [w_s.to(s.dtype), w_y.to(y.dtype)]) \
        if w_s is not None else ([y], [w_y.to(y.dtype)])
    return torch.autograd.grad(outs, xs[0], cots)[0]


def du_f64_distances(args, w_s, w_y) -> dict:
    """The step pair's du (through autograd, the ``step`` backward route)
    and the float32 loop's du, each against the loop's in float64: their
    max abs distances, max|du| in float64, and the plain order version's
    (``ref.mamba_scan_bwd_step``) distance."""
    from repro_torch.kernels import scan
    n0 = scan.mamba_scan.bwd_route_launches["step"]
    got = _du(scan.mamba_scan, args, w_s, w_y)
    assert scan.mamba_scan.bwd_route_launches["step"] == n0 + 1
    loop = _du(ref.mamba_scan, args, w_s, w_y)
    wide = _du(ref.mamba_scan, [a.double() for a in args], w_s, w_y)
    plain = ref.mamba_scan_bwd_step(*args, w_s, w_y)[0]
    assert torch.isfinite(got).all()
    return {"kernel": (got.double() - wide).abs().max().item(),
            "loop": (loop.double() - wide).abs().max().item(),
            "plain": (plain.double() - wide).abs().max().item(),
            "max_du": wide.abs().max().item()}


def _du_held(d, tag):
    assert d["kernel"] <= d["loop"] + DU_F64_MARGIN * d["max_du"], (tag, d)


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("regime", ["model", "near0", "near1"])
def test_cuda_scan_step_du_f64(cuda, regime, last):
    """The Mamba step pair's float32 du at T = 1 (B 2, 8192 channels),
    over 64 seeds: no farther from the loop in float64 than the float32
    loop is, plus 1e-4 of max|du| (where B·C cancels, du is a cancelled
    sum and a share of its largest is a few of its terms' ulps)."""
    worst = {"kernel": 0.0, "loop": 0.0, "plain": 0.0}
    for seed in DU_F64_SEEDS:
        args, w_s, w_y = _du_case(cuda, regime, 100 + seed)
        d = du_f64_distances(args, w_s if last else None, w_y)
        _du_held(d, (regime, last, seed))
        for k in worst:
            worst[k] = max(worst[k], d[k] / max(d["max_du"], 1e-300))
    print(f"[du-f64] {regime} {'with' if last else 'without'} ds, "
          f"{len(DU_F64_SEEDS)} seeds: worst distances from float64 as "
          f"shares of max|du|: kernel {worst['kernel']:.3g}, float32 loop "
          f"{worst['loop']:.3g}, plain order version {worst['plain']:.3g}")


def test_cuda_scan_step_du_f64_cancelling_draw(cuda):
    """The draw on which chip_smoke.py's step-pair sweep once failed
    (``tests/data/mamba_du_t1_draw.npz``: the pair's du against the
    float32 loop's, 1.48e-06 past 1e-4 of max|du| = 8.67e-07, where B·C
    cancels), held to the loop in float64 as the seeded draws are: the
    pair no farther from it than the float32 loop is, plus 1e-4 of
    max|du|."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "mamba_du_t1_draw.npz"))
    args = [torch.from_numpy(z[k]).to(cuda)
            for k in ("u", "delta", "bmat", "cmat", "a", "s0")]
    d = du_f64_distances(args, None, torch.from_numpy(z["dy"]).to(cuda))
    np.testing.assert_allclose(d["max_du"], 8.6665e-3, rtol=1e-4)
    _du_held(d, "cancelling draw")
    print(f"[du-f64] the cancelling draw: distances from float64 kernel "
          f"{d['kernel']:.4g}, float32 loop {d['loop']:.4g}, plain order "
          f"version {d['plain']:.4g}; max|du| {d['max_du']:.6g}")


# ---------------------------------------------------------------------------
# the SSM scans' step forwards
# ---------------------------------------------------------------------------

#: T on and off the step forwards' runs (RWKV-6 stages 8 tokens at a time,
#: Mamba 16)
STEP_FWD_T = (1, 2, 7, 8, 9, 15, 16, 17, 33, 65)


def _step_fwd_fns(kind):
    from repro_torch.kernels import scan
    return ((scan.rwkv6_scan, ref.rwkv6_scan, scan.rwkv6_scan_fwd,
             ref.rwkv6_scan_step) if kind == "rwkv" else
            (scan.mamba_scan, ref.mamba_scan, scan.mamba_scan_fwd,
             ref.mamba_scan_step))


def _step_fwd_check(cuda, kind, n, hd, t, dtype, offset, regime="model",
                    seed=90):
    """The step forward's entry on one case, twice: one launch each by
    the step route, bitwise the same; the last state the loop's bit for
    bit, y within SCAN_TOL of the loop's and bit for bit the plain version
    that sums in the kernel's order (RWKV-6 at T >= 2: T = 1 is the decode
    kernel's, another order)."""
    fn, plain, entry, order = _step_fwd_fns(kind)
    g = torch.Generator().manual_seed(seed + t + n)
    if kind == "rwkv":
        args = _scan_case(kind, cuda, dtype, 2, t, hd, seed=seed + t,
                          heads=n)
    else:
        args = _scan_case(kind, cuda, dtype, 2, t, n, seed=seed + t)
    args = _regime(args, kind, regime, g)
    if offset:
        args = [_off(a) for a in args]
    n0 = fn.route_launches["step"]
    got = entry(*args)
    again = entry(*args)
    torch.cuda.synchronize()
    assert fn.route_launches["step"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ws, wy = plain(*args)
    s, y = got
    assert s.dtype == torch.float32 and y.dtype == dtype
    assert torch.equal(s, ws)
    tol = SCAN_TOL[dtype]
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol,
                               atol=tol * wy.float().abs().max().item())
    if kind == "mamba" or t > 1:
        assert torch.equal(y, order(*args)[1])


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", STEP_FWD_T)
@pytest.mark.parametrize("kind,n,hd", STEP_BWD_SHAPES)
def test_cuda_scan_step_fwd_matches_the_loop(cuda, kind, n, hd, t, dtype,
                                             offset):
    """The step forwards (T = 1, unaligned tensors, Mamba's ragged widths;
    RWKV-6's kernel of T >= 2 and its decode kernel behind one entry) at T
    on and off their runs, every head width, ragged Mamba widths, aligned
    and one element off the 16-byte boundary: see ``_step_fwd_check``."""
    _step_fwd_check(cuda, kind, n, hd, t, dtype, offset)


@pytest.mark.parametrize("regime", ["near0", "near1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,n,hd,t", [("rwkv", 2, 64, 17),
                                         ("rwkv", 1, 16, 33),
                                         ("mamba", 300, 16, 17),
                                         ("mamba", 30, 16, 33)])
def test_cuda_scan_step_fwd_decay_regimes(cuda, kind, n, hd, t, dtype,
                                          regime):
    """The step forwards with decays near 0 (w exactly 0 in a fifth of
    RWKV-6's channels) and near 1, unaligned: see ``_step_fwd_check``."""
    _step_fwd_check(cuda, kind, n, hd, t, dtype, True, regime)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,n,hd", [("rwkv", 2, 64), ("mamba", 300, 16)])
def test_cuda_scan_step_fwd_long(cuda, kind, n, hd, dtype):
    """The step forwards at T = 2048, unaligned: see ``_step_fwd_check``."""
    _step_fwd_check(cuda, kind, n, hd, 2048, dtype, True)


def test_cuda_scan_step_fwd_takes_unaligned_and_ragged(cuda):
    """Through the scan, what the chunked routes refuse at T >= 2 takes
    the step route, one launch a call: an unaligned RWKV-6 r in both
    dtypes, Mamba's D = 30 and an unaligned u; and Mamba at T = 1 with an
    unaligned state (the decode route takes aligned ones)."""
    for kind, dtype, t, width, which in (
            ("rwkv", torch.bfloat16, 9, 64, 0),
            ("rwkv", torch.float32, 33, 64, 0),
            ("mamba", torch.bfloat16, 9, 30, None),
            ("mamba", torch.float32, 17, 64, 0),
            ("mamba", torch.bfloat16, 1, 64, 5)):
        fn, plain, _, _ = _step_fwd_fns(kind)
        args = _scan_case(kind, cuda, dtype, 2, t, width)
        if which is not None:
            args[which] = _off(args[which])
        before = dict(fn.route_launches)
        s, y = fn(*args)
        torch.cuda.synchronize()
        before["step"] += 1
        assert dict(fn.route_launches) == before, (kind, dtype, t, width)
        assert torch.equal(s, plain(*args)[0])


# ---------------------------------------------------------------------------
# the SSM scans' float32 chunked routes
# ---------------------------------------------------------------------------

#: the float32 routes' cases: (kind, heads or channels, head width, T);
#: T = 2, 17 and 65 (within a chunk of 16, across it, across a unit of
#: 64), every head width, Mamba at widths a multiple of 4 only (36: not
#: of 8, the float32 vector's rule); and the shapes the smoke configs'
#: training gives them (4 heads of 16, 64 channels, T = 16)
F32_CASES = [(kind, n, hd, t) for t in (2, 17, 65) for kind, n, hd in (
    ("rwkv", 3, 16), ("rwkv", 2, 32), ("rwkv", 64, 64), ("mamba", 36, 16),
    ("mamba", 1032, 16))] + [("rwkv", 4, 16, 16), ("mamba", 64, 16, 16)]


def _f32_case(cuda, kind, n, hd, t, regime):
    g = torch.Generator().manual_seed(60 + t)
    if kind == "rwkv":
        args = _scan_case(kind, cuda, torch.float32, 2, t, hd, heads=n)
    else:
        args = _scan_case(kind, cuda, torch.float32, 2, t, n)
    return _regime(args, kind, regime, g), g


@pytest.mark.parametrize("regime", ["model", "near0", "near1"])
@pytest.mark.parametrize("kind,n,hd,t", F32_CASES)
def test_cuda_scan_f32_routes_match_the_loop(cuda, kind, n, hd, t, regime):
    """The four float32 entries (RWKV-6 ``chunked`` and Mamba ``chunk``,
    forward and backward) against the float32 loop: the last state at
    SCAN_STATE_TOL and y at SCAN_TOL (rtol, and atol as a share of the
    largest), each of the six gradients within SCAN_GRAD_TOL of the
    largest of autograd through the loop, with and without a cotangent
    of the last state; the plan takes these routes, and each call counts
    one launch on it."""
    from repro_torch.kernels import scan
    fn, plain, plan = _scan_fns(kind)
    _, _, entry, _, route = _bwd_fns(kind)
    fwd = scan.rwkv6_chunked_fwd if kind == "rwkv" else scan.mamba_chunk_fwd
    args, g = _f32_case(cuda, kind, n, hd, t, regime)
    assert plan(*args) == route
    n0 = fn.route_launches[route]
    s, y = fwd(*args)
    torch.cuda.synchronize()
    assert fn.route_launches[route] == n0 + 1
    ws, wy = plain(*args)
    _f32_close(s, ws, SCAN_STATE_TOL)
    _f32_close(y, wy, SCAN_TOL[torch.float32])
    w_s = torch.randn(s.shape, generator=g).to(cuda)
    w_y = torch.randn(y.shape, generator=g).to(cuda)
    for ds in (w_s, None):
        n0 = fn.bwd_route_launches[route]
        got = entry(*args, ds, w_y)
        torch.cuda.synchronize()
        assert fn.bwd_route_launches[route] == n0 + 1
        want = _grads_through(plain, args, ds, w_y)
        for i, (a, b) in enumerate(zip(got, want)):
            b = torch.zeros_like(a) if b is None else b
            assert a.dtype == b.dtype == torch.float32, i
            assert torch.isfinite(a).all(), i
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            assert err <= SCAN_GRAD_TOL[torch.float32] * scale + 1e-30, (
                i, ds is None, err, scale)


@pytest.mark.parametrize("kind,width,t", [("rwkv", 64, 37), ("rwkv", 16, 2),
                                          ("mamba", 300, 33),
                                          ("mamba", 128, 70)])
def test_cuda_scan_f32_step_entries_are_bitwise_the_loop(cuda, kind, width,
                                                         t):
    """The float32 step entries, now the timing baseline and the route of
    T = 1 and unaligned tensors, keep the loop's roundings: their last
    state is the float32 loop's bit for bit."""
    from repro_torch.kernels import scan
    _, plain, _ = _scan_fns(kind)
    step = scan.rwkv6_scan_fwd if kind == "rwkv" else scan.mamba_scan_fwd
    args = _scan_case(kind, cuda, torch.float32, 3, t, width)
    s, y = step(*args)
    ws, wy = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(s, ws)
    tol = SCAN_TOL[torch.float32]
    torch.testing.assert_close(y, wy, rtol=tol,
                               atol=tol * wy.abs().max().item())


def test_cuda_scan_f32_unaligned_and_ragged_go_by_step(cuda):
    """float32 tensors the chunked routes cannot take launch the step
    kernels: an unaligned r or u, Mamba's D = 30 (not a multiple of 4)."""
    from repro_torch.kernels import scan
    for kind, width, which in (("rwkv", 64, 0), ("mamba", 64, 0),
                               ("mamba", 30, None)):
        fn, plain, plan = _scan_fns(kind)
        args = _scan_case(kind, cuda, torch.float32, 2, 9, width)
        if which is not None:
            flat = torch.empty(args[which].numel() + 1, device=cuda)
            moved = flat[1:].view(args[which].shape)
            moved.copy_(args[which])
            args[which] = moved
        assert plan(*args) == "step", (kind, width)
        n0 = fn.route_launches["step"]
        s, y = fn(*args)
        torch.cuda.synchronize()
        assert fn.route_launches["step"] == n0 + 1
        ws, wy = plain(*args)
        assert torch.equal(s, ws)


# ---------------------------------------------------------------------------
# chunked attention (the reference's device loop over key chunks)
# ---------------------------------------------------------------------------

#: Tq, Tk: one query and one key, past a 64-row tile, past a chunk of 512
ATTN_SHAPES = [(1, 1), (7, 9), (256, 512), (256, 513), (1500, 1500),
               (1, 1024)]
#: (causal, q_offset)
ATTN_MASKS = [(False, 0), (False, 37), (True, 0), (True, 37)]
#: float32 tolerances of max|want|: the output; the gradients (of the
#: largest of dq, dk and dv: dq and dk vanish where a row has one live
#: key, leaving only the float32 rounding of dP - D)
ATTN_F32_TOL, ATTN_F32_GRAD_TOL = 1e-5, 1e-4


def _attn_case(dev, dtype, tq, tk, d, seed=40, b=2, h=2):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, h, t, d), generator=g).to(dtype).to(dev)
            for t in (tq, tk, tk, tq)]


def _attn_through(fn, q, k, v, dout, causal, q_offset):
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*xs, causal=causal, q_offset=q_offset)
    return [out.detach()] + list(torch.autograd.grad(out, xs, dout))


def _attn_loop(q, k, v, *, causal, q_offset):
    return ref.chunked_attention(q, k, v, causal=causal, q_offset=q_offset)


def _attn_allow(got, want, loop, dtype, grads):
    """Assert each of ``got`` within the allowance of the float32 loop's
    ``want``: float32 at ``ATTN_F32_TOL`` (output) / ``ATTN_F32_GRAD_TOL``
    (gradients, of the largest); bf16 no further from it than the bf16
    loop's ``loop`` plus one bf16 ulp of max|want|."""
    g_scale = max(w.abs().max().item() for w in want) if grads else 0.0
    for i, (g, w, lp) in enumerate(zip(got, want, loop)):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all(), i
        scale = g_scale if grads else w.abs().max().item()
        err = (g.float() - w).abs().max().item()
        if dtype == torch.float32:
            allow = (ATTN_F32_GRAD_TOL if grads else ATTN_F32_TOL) * scale
        else:
            allow = (lp.float() - w).abs().max().item() + 2.0 ** (
                np.floor(np.log2(max(scale, 1e-30))) - 7)
        assert err <= allow, (i, err, allow)


@pytest.mark.parametrize("causal,q_offset", ATTN_MASKS)
@pytest.mark.parametrize("tq,tk", ATTN_SHAPES)
@pytest.mark.parametrize("d", [16, 64, 112, 128, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_attention_matches_plain(cuda, dtype, d, tq, tk, causal,
                                              q_offset):
    """The kernels, forward and backward through autograd, against the
    plain loop: float32 at ``ATTN_F32_TOL`` / ``ATTN_F32_GRAD_TOL``;
    bf16 against the loop run in float32 on the same values, no further
    from it than the bf16 loop is plus one bf16 ulp of max|want|."""
    from repro_torch.kernels import chunked_attention as ca
    args = _attn_case(cuda, dtype, tq, tk, d)
    got = _attn_through(ca.chunked_attention, *args, causal, q_offset)
    want = _attn_through(_attn_loop, *(a.float() for a in args), causal,
                         q_offset)
    loop = _attn_through(_attn_loop, *args, causal, q_offset)
    g_scale = max(w.abs().max().item() for w in want[1:])
    for i, (g, w, lp) in enumerate(zip(got, want, loop)):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all(), i
        scale = w.abs().max().item() if i == 0 else g_scale
        err = (g.float() - w).abs().max().item()
        if dtype == torch.float32:
            allow = (ATTN_F32_TOL if i == 0 else ATTN_F32_GRAD_TOL) * scale
        else:
            allow = (lp.float() - w).abs().max().item() + 2.0 ** (
                np.floor(np.log2(max(scale, 1e-30))) - 7)
        assert err <= allow, (i, err, allow)


def test_cuda_chunked_attention_counts_and_never_loops(cuda, monkeypatch):
    """On CUDA tensors the layer launches the forward kernel once and the
    backward entry once a call, in both dtypes, and never the plain loop
    (made to raise); a transposed view gives the contiguous inputs'
    result bitwise."""
    from repro_torch.kernels import chunked_attention as ca
    from repro_torch.models import layers

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain loop")

    monkeypatch.setattr(ref, "chunked_attention", refuse)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = _attn_case(cuda, dtype, 70, 600, 64)
        before = (ca.chunked_attention.launches,
                  ca.chunked_attention.bwd_launches)
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = layers.chunked_attention(*xs, causal=True, q_offset=530)
        out.backward(dout)
        assert (ca.chunked_attention.launches,
                ca.chunked_attention.bwd_launches) == (before[0] + 1,
                                                       before[1] + 1)
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        assert not qt.is_contiguous()
        assert torch.equal(ops.chunked_attention(qt, k, v, causal=True,
                                                 q_offset=530),
                           out.detach())
    torch.cuda.synchronize()


def test_cuda_chunked_attention_backward_is_deterministic(cuda):
    """No atomics: two backward launches on the same inputs give the same
    gradients bit for bit."""
    from repro_torch.kernels import chunked_attention as ca
    q, k, v, dout = _attn_case(cuda, torch.bfloat16, 300, 700, 128)
    out, lse = ca.chunked_attention_fwd(q, k, v, True, 400)
    first = ca.chunked_attention_bwd(q, k, v, out, dout, lse, True, 400)
    second = ca.chunked_attention_bwd(q, k, v, out, dout, lse, True, 400)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_cuda_chunked_attention_refuses_what_it_is_not_built_for(cuda):
    """A head width the kernels are not built for, or a dtype, raises on
    CUDA tensors; nothing falls back to the loop."""
    q, k, v, _ = _attn_case(cuda, torch.bfloat16, 4, 4, 32)
    with pytest.raises(ValueError):
        ops.chunked_attention(q, k, v, causal=True)
    q, k, v, _ = _attn_case(cuda, torch.float16, 4, 4, 64)
    with pytest.raises(TypeError):
        ops.chunked_attention(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# chunked attention by route
# ---------------------------------------------------------------------------

#: the routes' edge sweep: Tk on both sides of a 64- and a 128-key tile
#: and of the chunk of 512, Tq on both sides of the split threshold and
#: of a 64- and a 128-row tile
ROUTE_TK = (1, 9, 127, 128, 129, 513, 1500)
ROUTE_TQ = (1, 7, 64, 129, 1500)
#: the backward sweep's shapes
ROUTE_BWD_SHAPES = [(1, 1), (7, 9), (64, 128), (129, 129), (129, 513),
                    (1500, 1500), (1, 1500)]
#: forward routes and the widths they take
FWD_ROUTES = [("tile", torch.bfloat16, (64, 112, 128, 160)),
              ("split", torch.bfloat16, (16, 64, 112, 128, 160)),
              ("mma", torch.bfloat16, (16, 64, 112, 128, 160)),
              ("simt", torch.float32, (16, 64, 112, 128, 160))]


def _route_fwd(route):
    from repro_torch.kernels import chunked_attention as ca
    return {"tile": ca.tile_fwd, "split": ca.split_fwd, "mma": ca.mma_fwd,
            "simt": ca.mma_fwd}[route]


def _route_bwd(route):
    from repro_torch.kernels import chunked_attention as ca
    return {"tile": ca.tile_bwd, "mma": ca.mma_bwd, "simt": ca.mma_bwd}[route]


def _want(q, k, v, dout, causal, q_offset, grads):
    """The float32 loop's and the loop's own (in q's dtype) output, or
    gradients, on the same values."""
    if not grads:
        return ([_attn_loop(q.float(), k.float(), v.float(), causal=causal,
                            q_offset=q_offset)],
                [_attn_loop(q, k, v, causal=causal, q_offset=q_offset)])
    want = _attn_through(_attn_loop, *(a.float() for a in (q, k, v, dout)),
                         causal, q_offset)[1:]
    loop = _attn_through(_attn_loop, q, k, v, dout, causal, q_offset)[1:]
    return want, loop


@pytest.mark.parametrize("causal,q_offset", ATTN_MASKS)
@pytest.mark.parametrize("route,dtype,d", [
    (r, dt, d) for r, dt, ds in FWD_ROUTES for d in ds])
def test_cuda_chunked_attention_route_forward(cuda, route, dtype, d, causal,
                                              q_offset):
    """Each forward route, launched by itself, against the plain loop at
    every Tq of ``ROUTE_TQ`` against every Tk of ``ROUTE_TK``: the output
    within the allowance and the log-sum-exp within 1e-4 of the float32
    loop's; two runs bitwise equal; one launch counted to the route."""
    from repro_torch.kernels import chunked_attention as ca
    fn = _route_fwd(route)
    for tq in ROUTE_TQ:
        for tk in ROUTE_TK:
            q, k, v, dout = _attn_case(cuda, dtype, tq, tk, d, seed=tq + tk)
            before = ca.chunked_attention.route_launches[route]
            out, lse = fn(q, k, v, causal, q_offset)
            again = fn(q, k, v, causal, q_offset)
            assert ca.chunked_attention.route_launches[route] == before + 2
            assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
            want, loop = _want(q, k, v, dout, causal, q_offset, False)
            _attn_allow([out], want, loop, dtype, False)
            _, wl = ref.chunked_attention(q.float(), k.float(), v.float(),
                                          causal=causal, q_offset=q_offset,
                                          return_lse=True)
            assert lse.dtype == torch.float32
            assert (lse - wl).abs().max().item() <= 1e-4 * max(
                1.0, wl.abs().max().item()), (tq, tk)


#: backward route, forward route, dtype, widths
BWD_CASES = ([("tile", f, torch.bfloat16, d) for f in ("tile", "split", "mma")
              for d in (64, 112, 128, 160)]
             + [("mma", f, torch.bfloat16, d) for f in ("split", "mma")
                for d in (16, 64, 112, 128, 160)]
             + [("mma", "tile", torch.bfloat16, d)
                for d in (64, 112, 128, 160)]
             + [("simt", "simt", torch.float32, d)
                for d in (16, 64, 112, 128, 160)])


@pytest.mark.parametrize("causal,q_offset", ATTN_MASKS)
@pytest.mark.parametrize("bwd,fwd,dtype,d", BWD_CASES)
def test_cuda_chunked_attention_route_backward(cuda, bwd, fwd, dtype, d,
                                               causal, q_offset):
    """Each backward route from the output and log-sum-exp of each forward
    route, against autograd through the plain loop: the gradients of q, k
    and v within the allowance (of the largest); two runs bitwise
    equal."""
    from repro_torch.kernels import chunked_attention as ca
    for tq, tk in ROUTE_BWD_SHAPES:
        q, k, v, dout = _attn_case(cuda, dtype, tq, tk, d, seed=3 * tq + tk)
        out, lse = _route_fwd(fwd)(q, k, v, causal, q_offset)
        before = ca.chunked_attention.bwd_route_launches[bwd]
        got = _route_bwd(bwd)(q, k, v, out, dout, lse, causal, q_offset)
        again = _route_bwd(bwd)(q, k, v, out, dout, lse, causal, q_offset)
        assert ca.chunked_attention.bwd_route_launches[bwd] == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want, loop = _want(q, k, v, dout, causal, q_offset, True)
        _attn_allow(got, want, loop, dtype, True)


def test_cuda_chunked_attention_routes_follow_the_plan(cuda, monkeypatch):
    """Through the layer, each call takes its planned routes (the counts
    by route move by one), and the plain loop (made to raise) is never
    reached: decode by split, prefill and training by tile at d 64, 112,
    128 and 160, mma at d 16 past 64 keys, simt in float32 at other
    widths, head at d 16 up to 64 queries and keys in both dtypes."""
    from repro_torch.kernels import chunked_attention as ca
    from repro_torch.models import layers

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain loop")

    monkeypatch.setattr(ref, "chunked_attention", refuse)
    cases = [(torch.float32, 16, 24, 16, "head", "head"),
             (torch.bfloat16, 64, 64, 16, "head", "head"),
             (torch.bfloat16, 1, 24, 16, "head", "head"),
             (torch.bfloat16, 1, 300, 64, "split", "tile"),
             (torch.bfloat16, 1, 300, 160, "split", "tile"),
             (torch.bfloat16, 200, 300, 128, "tile", "tile"),
             (torch.bfloat16, 200, 300, 112, "tile", "tile"),
             (torch.bfloat16, 200, 300, 160, "tile", "tile"),
             (torch.bfloat16, 200, 300, 16, "mma", "mma"),
             (torch.float32, 200, 300, 64, "simt", "simt")]
    for dtype, tq, tk, d, fwd, bwd in cases:
        q, k, v, dout = _attn_case(cuda, dtype, tq, tk, d)
        before = (dict(ca.chunked_attention.route_launches),
                  dict(ca.chunked_attention.bwd_route_launches))
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        layers.chunked_attention(*xs, causal=True, q_offset=5).backward(dout)
        after = (ca.chunked_attention.route_launches,
                 ca.chunked_attention.bwd_route_launches)
        for got, was, route in zip(after, before, (fwd, bwd)):
            assert {r: got[r] - was[r] for r in got} == {
                r: int(r == route) for r in got}, (dtype, tq, d)
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", ["tile", "split"])
def test_cuda_chunked_attention_route_refuses_other_widths(cuda, route):
    """A route launched at a width it is not built for raises; nothing
    falls back to another route or to the loop."""
    width = 16 if route == "tile" else 32
    q, k, v, _ = _attn_case(cuda, torch.bfloat16, 4, 9, width)
    with pytest.raises(RuntimeError):
        _route_fwd(route)(q, k, v, True, 0)


# ---------------------------------------------------------------------------
# the tile route at d 112 and 160: whole 64-column chunks, padded
# ---------------------------------------------------------------------------

#: Tq, Tk: two queries, Tq and Tk off every tile (64 and 128 rows, 64 and
#: 128 keys), a key tile and a chunk of 512 crossed
WIDE_SHAPES = [(2, 9), (2, 600), (7, 129), (70, 64), (129, 513), (300, 257)]


@pytest.mark.parametrize("causal,q_offset", ATTN_MASKS)
@pytest.mark.parametrize("d", [112, 160])
def test_cuda_chunked_attention_tile_wide_heads(cuda, d, causal, q_offset):
    """The tile forward and backward at d 112 and 160 (the dK / dV split by
    64-column chunks at d 112, a dV and a dK launch at d 160) against
    the float32 loop within the d-64/128 tile tests' allowance at every
    shape of ``WIDE_SHAPES``; two runs bitwise equal."""
    from repro_torch.kernels import chunked_attention as ca
    for tq, tk in WIDE_SHAPES:
        q, k, v, dout = _attn_case(cuda, torch.bfloat16, tq, tk, d,
                                   seed=tq * tk + d)
        out, lse = ca.tile_fwd(q, k, v, causal, q_offset)
        assert torch.equal(out, ca.tile_fwd(q, k, v, causal, q_offset)[0])
        want, loop = _want(q, k, v, dout, causal, q_offset, False)
        _attn_allow([out], want, loop, torch.bfloat16, False)
        got = ca.tile_bwd(q, k, v, out, dout, lse, causal, q_offset)
        again = ca.tile_bwd(q, k, v, out, dout, lse, causal, q_offset)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want, loop = _want(q, k, v, dout, causal, q_offset, True)
        _attn_allow(got, want, loop, torch.bfloat16, True)


def _poisoned(like, extra=4096):
    """A view shaped as ``like`` at the start of a buffer of bf16 poison
    (a NaN pattern) that runs ``extra`` elements past it."""
    buf = torch.full((like.numel() + extra,), -1, dtype=torch.int16,
                     device=like.device).view(torch.bfloat16)
    return buf, buf[:like.numel()].view(like.shape)


@pytest.mark.parametrize("d", [112, 160])
def test_cuda_chunked_attention_tile_stores_only_true_columns(cuda, d):
    """The padded chunks' columns past d never reach an output: out, dq,
    dk and dv written into buffers poisoned past their last element
    leave the poison there, and hold the loop's values."""
    from repro_torch.kernels import chunked_attention as ca
    from repro_torch.kernels.build import check, load
    from repro_torch.kernels.dispatch import stream_of
    q, k, v, dout = _attn_case(cuda, torch.bfloat16, 129, 200, d, seed=d)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    obuf, out = _poisoned(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=cuda)
    fwd = load("chunked_attention_sm90").chunked_attention_tile_fwd_bf16
    bwd = load("chunked_attention_bwd_sm90").chunked_attention_tile_bwd_bf16
    check(fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * h, tq, tk, d, 1, 5, stream_of(q)), "forward")
    bufs = [_poisoned(t) for t in (q, k, v)]
    stats = torch.empty(2 * b * h * (-(-tq // ca.STAT_ROWS) * ca.STAT_ROWS),
                        dtype=torch.float32, device=cuda)
    dq, dk, dv = (g for _, g in bufs)
    check(bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, tq, tk, d, 1, 5,
        stream_of(q)), "backward")
    torch.cuda.synchronize()
    for buf, t in [(obuf, out)] + bufs:
        tail = buf[t.numel():].view(torch.int16)
        assert torch.equal(tail, torch.full_like(tail, -1))
    want, loop = _want(q, k, v, dout, True, 5, False)
    _attn_allow([out], want, loop, torch.bfloat16, False)
    want, loop = _want(q, k, v, dout, True, 5, True)
    _attn_allow([dq, dk, dv], want, loop, torch.bfloat16, True)


# ---------------------------------------------------------------------------
# the head route: d 16, at most 64 queries and keys, one block a head
# ---------------------------------------------------------------------------

#: Tq and Tk of the head route's sweep: one, a 16-row tile and either side
#: of it, the smoke configs' encoder length, the limit and one under it
HEAD_T = (1, 2, 15, 16, 17, 24, 63, 64)


@pytest.mark.parametrize("causal,q_offset", ATTN_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_attention_head_matches_plain(cuda, dtype, causal,
                                                   q_offset):
    """Through the entry, every Tq of ``HEAD_T`` against every Tk takes the
    ``head`` route, forward and backward (one launch each, counted to it),
    and holds the plain loop: the output, the log-sum-exp within 1e-4 of
    the float32 loop's and the gradients within the allowance
    (``_attn_allow``); two runs bitwise equal.  Its backward from the
    ``mma`` / ``simt`` forward's output and log-sum-exp holds the same."""
    from repro_torch.kernels import chunked_attention as ca
    for tq in HEAD_T:
        for tk in HEAD_T:
            q, k, v, dout = _attn_case(cuda, dtype, tq, tk, 16,
                                       seed=7 * tq + tk)
            fwd = dict(ca.chunked_attention.route_launches)
            bwd = dict(ca.chunked_attention.bwd_route_launches)
            got = _attn_through(ca.chunked_attention, q, k, v, dout, causal,
                                q_offset)
            again = _attn_through(ca.chunked_attention, q, k, v, dout,
                                  causal, q_offset)
            for counts, was in ((ca.chunked_attention.route_launches, fwd),
                                (ca.chunked_attention.bwd_route_launches,
                                 bwd)):
                assert {r: counts[r] - was[r] for r in counts} == {
                    r: 2 * (r == "head") for r in counts}, (tq, tk)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            want, loop = _want(q, k, v, dout, causal, q_offset, False)
            _attn_allow(got[:1], want, loop, dtype, False)
            want, loop = _want(q, k, v, dout, causal, q_offset, True)
            _attn_allow(got[1:], want, loop, dtype, True)
            out, lse = ca.head_fwd(q, k, v, causal, q_offset)
            _, wl = ref.chunked_attention(q.float(), k.float(), v.float(),
                                          causal=causal, q_offset=q_offset,
                                          return_lse=True)
            assert (lse - wl).abs().max().item() <= 1e-4 * max(
                1.0, wl.abs().max().item()), (tq, tk)
            o2, l2 = ca.mma_fwd(q, k, v, causal, q_offset)
            _attn_allow(ca.head_bwd(q, k, v, o2, dout, l2, causal, q_offset),
                        want, loop, dtype, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_attention_head_is_one_launch(cuda, dtype):
    """Through the layer at a smoke shape, a forward and a backward are
    one launch each, both counted to ``head``, and no other route moves;
    the backward needs no workspace: it allocates only dq, dk and dv."""
    from repro_torch.kernels import chunked_attention as ca
    from repro_torch.models import layers
    q, k, v, dout = _attn_case(cuda, dtype, 16, 24, 16)
    before = (ca.chunked_attention.launches,
              ca.chunked_attention.bwd_launches,
              dict(ca.chunked_attention.route_launches),
              dict(ca.chunked_attention.bwd_route_launches))
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    layers.chunked_attention(*xs, causal=True, q_offset=3).backward(dout)
    assert (ca.chunked_attention.launches - before[0],
            ca.chunked_attention.bwd_launches - before[1]) == (1, 1)
    for counts, was in zip((ca.chunked_attention.route_launches,
                            ca.chunked_attention.bwd_route_launches),
                           before[2:]):
        assert {r: counts[r] - was[r] for r in counts} == {
            r: int(r == "head") for r in counts}
    out, lse = ca.head_fwd(q, k, v, True, 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = ca.head_bwd(q, k, v, out, dout, lse, True, 3)
    torch.cuda.synchronize()
    kept = sum(g.numel() * g.element_size() for g in grads)
    assert torch.cuda.max_memory_allocated() - base == kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_attention_head_backward_is_one_kernel(cuda, dtype):
    """The profiler sees only the route's own kernel on the device over
    five ``head`` backward calls (and five forward ones), at most one a
    call: D, dK, dV and dQ in one block, no delta kernel, no copy.  (A
    trace of such calls can miss a kernel now and then, so the count is
    held from above.)"""
    from repro_torch.kernels import chunked_attention as ca
    from torch.autograd import DeviceType
    q, k, v, dout = _attn_case(cuda, dtype, 64, 64, 16)
    out, lse = ca.head_fwd(q, k, v, True, 0)
    ca.head_bwd(q, k, v, out, dout, lse, True, 0)
    torch.cuda.synchronize()
    for call, name in ((lambda: ca.head_bwd(q, k, v, out, dout, lse, True,
                                            0), "attn_head_bwd_kernel"),
                       (lambda: ca.head_fwd(q, k, v, True, 0),
                        "attn_head_fwd_kernel")):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA]
        assert 1 <= len(kernels) <= 5, kernels
        assert all(name in k for k in kernels), kernels


@pytest.mark.parametrize("tq,tk,d", [(65, 16, 16), (16, 65, 16),
                                     (16, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_attention_head_refuses_past_its_limits(cuda, dtype,
                                                             tq, tk, d):
    """A CUDA call sent to ``head`` past 64 queries or keys, or at another
    width, raises, forward and backward, and no route launches: nothing
    falls back to another route or to the loop."""
    from repro_torch.kernels import chunked_attention as ca
    q, k, v, dout = _attn_case(cuda, dtype, tq, tk, d)
    lse = torch.zeros(q.shape[:3], dtype=torch.float32, device=cuda)
    before = (dict(ca.chunked_attention.route_launches),
              dict(ca.chunked_attention.bwd_route_launches))
    with pytest.raises(RuntimeError):
        ca.head_fwd(q, k, v, True, 0)
    with pytest.raises(RuntimeError):
        ca.head_bwd(q, k, v, q, dout, lse, True, 0)
    assert (ca.chunked_attention.route_launches,
            ca.chunked_attention.bwd_route_launches) == before
