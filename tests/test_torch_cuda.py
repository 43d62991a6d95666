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
from repro_torch.kernels.spec_gather import spec_gather
from repro_torch.kernels.spec_scatter import spec_scatter_add

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
