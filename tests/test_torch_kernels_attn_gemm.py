"""The port's grouped-GEMM and attention kernels against the JAX reference.

* the plain PyTorch versions (``repro_torch.kernels.ref``) against
  ``repro.kernels.ref`` on the same seeded numpy inputs, at
  ``tests/test_kernels.py``'s sweep shapes and tolerances (float32:
  ``1e-3`` GEMM, ``2e-3`` attention);
* the plain versions against the Pallas kernels in interpret mode, on
  inputs where the two JAX answers agree (flash at ``tq == tk``; paged
  with every row live and every page id in the pool);
* the settled semantics, each in its own test: causal masks align
  bottom-right when ``tq != tk`` (``repro.kernels.ref``, not the Pallas
  grid), rows with no live key are exactly zero, page ids past the pool
  clip like the reference, paged decode equals dense attention over the
  materialised cache;
* the wrappers and ``repro_torch.kernels.ops``: CPU tensors run the plain
  version and launch nothing, the API reaches the same results as the
  kernel modules, bad inputs raise, bfloat16 stays within bfloat16
  tolerance of float32.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_attention as jpaged
from repro.kernels.ragged_matmul import ragged_matmul as jragged
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ragged_matmul import ragged_matmul

#: tests/test_kernels.py's float32 tolerances (rtol = atol)
GEMM_TOL, ATTN_TOL = 1e-3, 2e-3
#: bfloat16 against float32 on the same inputs: inputs, p and the output
#: round to 8 bits of mantissa (2**-8 ~ 4e-3 relative each)
BF16_TOL = 5e-2

RAGGED_SHAPES = [(4, 64, 128, 256), (2, 128, 256, 128), (8, 32, 64, 64)]
FLASH_SHAPES = [(2, 3, 256, 64), (1, 2, 128, 128), (1, 1, 512, 64)]
PAGED_SHAPES = [(3, 4, 64, 16, 8, 5), (1, 8, 128, 8, 16, 3),
                (2, 2, 64, 32, 8, 8)]


def _arr(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _paged_inputs(b, h, d, p, page, nmax, seed, poison_tail=True):
    """tests/test_kernels.py's paged inputs: in-pool page ids, seq_lens in
    [1, page * nmax), pages past each sequence's end ``-1``."""
    rng = np.random.default_rng(seed)
    q = _arr(rng, (b, h, d))
    kp, vp = _arr(rng, (p, page, h, d)), _arr(rng, (p, page, h, d))
    pt = rng.integers(0, p, (b, nmax)).astype(np.int32)
    seq = rng.integers(1, page * nmax, b).astype(np.int32)
    if poison_tail:
        used = (seq + page - 1) // page
        for i in range(b):
            pt[i, used[i]:] = -1
    return q, kp, vp, pt, seq


# ---------------------------------------------------------------------------
# plain versions vs repro.kernels.ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,c,d,f", RAGGED_SHAPES + [(3, 56, 96, 200),
                                                     (2, 13, 37, 45)])
def test_plain_ragged_matches_reference_ref(e, c, d, f):
    rng = np.random.default_rng(e * c + f)
    x, w = _arr(rng, (e * c, d)), _arr(rng, (e, d, f))
    got = ref.ragged_matmul(*_t(x, w), c)
    assert got.dtype == torch.float32
    _close(got, jref.ragged_matmul(jnp.asarray(x), jnp.asarray(w), c),
           GEMM_TOL)


@pytest.mark.parametrize("b,h,t,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference_ref(b, h, t, d, causal):
    rng = np.random.default_rng(b * t + d)
    q, k, v = (_arr(rng, (b, h, t, d)) for _ in range(3))
    got = ref.flash_attention(*_t(q, k, v), causal=causal)
    _close(got, jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal), ATTN_TOL)


@pytest.mark.parametrize("b,h,d,p,page,nmax", PAGED_SHAPES)
def test_plain_paged_matches_reference_ref(b, h, d, p, page, nmax):
    q, kp, vp, pt, seq = _paged_inputs(b, h, d, p, page, nmax, seed=b + d)
    got = ref.paged_attention(*_t(q, kp, vp, pt, seq))
    _close(got, jref.paged_attention(*map(jnp.asarray,
                                          (q, kp, vp, pt, seq))), ATTN_TOL)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,c,d,f,bm,bn,bk", [
    (4, 64, 128, 256, 32, 128, 64),
    (2, 128, 256, 128, 128, 128, 128),
    (8, 32, 64, 64, 32, 64, 64),
])
def test_plain_ragged_matches_pallas_interpret(e, c, d, f, bm, bn, bk):
    rng = np.random.default_rng(e + c)
    x, w = _arr(rng, (e * c, d)), _arr(rng, (e, d, f))
    want = jragged(jnp.asarray(x), jnp.asarray(w), capacity=c, bm=bm, bn=bn,
                   bk=bk, interpret=True)
    _close(ref.ragged_matmul(*_t(x, w), c), want, GEMM_TOL)


@pytest.mark.parametrize("b,h,t,d,bq,bk", [(2, 3, 256, 64, 64, 64),
                                           (1, 2, 128, 128, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_interpret(b, h, t, d, bq, bk, causal):
    """At tq == tk the Pallas top-left and the reference's bottom-right
    masks coincide."""
    rng = np.random.default_rng(t + d)
    q, k, v = (_arr(rng, (b, h, t, d)) for _ in range(3))
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, bq=bq, bk=bk,
                  interpret=True)
    _close(ref.flash_attention(*_t(q, k, v), causal=causal), want, ATTN_TOL)


@pytest.mark.parametrize("b,h,d,p,page,nmax", PAGED_SHAPES)
def test_plain_paged_matches_pallas_interpret(b, h, d, p, page, nmax):
    """Every row live and every page id in the pool: where the Pallas
    kernel and the reference agree."""
    q, kp, vp, pt, seq = _paged_inputs(b, h, d, p, page, nmax, seed=nmax)
    want = jpaged(*map(jnp.asarray, (q, kp, vp, pt, seq)), interpret=True)
    _close(ref.paged_attention(*_t(q, kp, vp, pt, seq)), want, ATTN_TOL)


# ---------------------------------------------------------------------------
# the settled semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk", [(64, 160), (160, 64), (1, 77), (100, 99)])
def test_causal_unequal_lengths_align_bottom_right(tq, tk):
    """Causal with tq != tk follows repro.kernels.ref (tril(k=tk-tq)), not
    the Pallas kernel's top-left grid; rows the reference leaves NaN (no
    live key) are compared by the dead-row test."""
    rng = np.random.default_rng(tq + tk)
    q = _arr(rng, (1, 2, tq, 64))
    k, v = _arr(rng, (1, 2, tk, 64)), _arr(rng, (1, 2, tk, 64))
    want = np.asarray(jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=True))
    got = flash_attention(*_t(q, k, v), causal=True).numpy()
    live = max(tq - tk, 0)
    np.testing.assert_allclose(got[:, :, live:], want[:, :, live:],
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    assert not np.isnan(want[:, :, live:]).any()


def test_dead_rows_are_exactly_zero():
    """Rows with no live key give zeros, in float32 and bfloat16: causal
    rows i < tq - tk, seq_len 0, and a row whose pages are all -1 (the
    reference gives NaN there, the Pallas paged kernel the mean of V)."""
    rng = np.random.default_rng(5)
    tq, tk = 90, 40
    q = _arr(rng, (2, 2, tq, 64))
    k, v = _arr(rng, (2, 2, tk, 64)), _arr(rng, (2, 2, tk, 64))
    pq, kp, vp, pt, seq = _paged_inputs(3, 4, 64, 16, 8, 5, seed=5)
    seq[0] = 0
    pt[2] = -1
    want = np.asarray(jref.paged_attention(*map(jnp.asarray,
                                                (pq, kp, vp, pt, seq))))
    assert np.isnan(want[0]).all() and np.isnan(want[2]).all()
    for dtype in (torch.float32, torch.bfloat16):
        tq_, tk_, tv_ = (t.to(dtype) for t in _t(q, k, v))
        got = flash_attention(tq_, tk_, tv_, causal=True)
        assert torch.equal(got[:, :, :tq - tk],
                           torch.zeros_like(got[:, :, :tq - tk]))
        assert got[:, :, tq - tk:].abs().sum() > 0
        pq_, kp_, vp_ = (t.to(dtype) for t in _t(pq, kp, vp))
        got = paged_attention(pq_, kp_, vp_, *_t(pt, seq))
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        np.testing.assert_allclose(got[1].float().numpy(), want[1],
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_paged_page_id_past_pool_clips_like_reference():
    b, h, d, p, page, nmax = 2, 4, 64, 8, 8, 4
    q, kp, vp, pt, seq = _paged_inputs(b, h, d, p, page, nmax, seed=11,
                                       poison_tail=False)
    seq[:] = page * nmax
    pt[0, 1] = p          # one past the pool
    pt[1, :] = p + 100    # far past it
    want = jref.paged_attention(*map(jnp.asarray, (q, kp, vp, pt, seq)))
    got = paged_attention(*_t(q, kp, vp, pt, seq))
    _close(got, want, ATTN_TOL)
    clipped = pt.copy()
    clipped[pt >= p] = p - 1
    _close(got, ref.paged_attention(*_t(q, kp, vp, clipped, seq)), 0)


def test_paged_matches_dense_decode():
    """Paged decode == dense attention over the materialised cache."""
    rng = np.random.default_rng(2)
    b, h, d, page, t = 2, 4, 64, 8, 40
    n_pages = t // page + 1
    q1 = _arr(rng, (b, h, 1, d))
    k, v = _arr(rng, (b, h, t, d)), _arr(rng, (b, h, t, d))
    want = flash_attention(*_t(q1, k, v), causal=False)[:, :, 0]
    pool_k = np.zeros((b * n_pages, page, h, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    pt = np.full((b, n_pages), -1, np.int32)
    for i in range(b):
        for pg in range((t + page - 1) // page):
            pid = i * n_pages + pg
            lo, hi = pg * page, min((pg + 1) * page, t)
            pool_k[pid, :hi - lo] = k[i, :, lo:hi].transpose(1, 0, 2)
            pool_v[pid, :hi - lo] = v[i, :, lo:hi].transpose(1, 0, 2)
            pt[i, pg] = pid
    got = paged_attention(*_t(q1[:, :, 0], pool_k, pool_v, pt,
                              np.full((b,), t, np.int32)))
    _close(got, want.numpy(), ATTN_TOL)


# ---------------------------------------------------------------------------
# wrappers and the public API
# ---------------------------------------------------------------------------


def _small_inputs():
    rng = np.random.default_rng(9)
    gemm = _t(_arr(rng, (2 * 24, 64)), _arr(rng, (2, 64, 32)))
    attn = _t(*(_arr(rng, (1, 2, 40, 64)) for _ in range(3)))
    paged = _t(*_paged_inputs(3, 4, 64, 16, 8, 5, seed=9))
    return gemm, attn, paged


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    (x, w), (q, k, v), paged = _small_inputs()
    counters = (ragged_matmul, flash_attention, paged_attention)
    before = [c.launches for c in counters]
    assert torch.equal(ragged_matmul(x, w, capacity=24),
                       ref.ragged_matmul(x, w, 24))
    for causal in (True, False):
        assert torch.equal(flash_attention(q, k, v, causal=causal),
                           ref.flash_attention(q, k, v, causal=causal))
    assert torch.equal(paged_attention(*paged), ref.paged_attention(*paged))
    assert [c.launches for c in counters] == before


def test_ops_api_reaches_the_kernel_modules():
    (x, w), (q, k, v), paged = _small_inputs()
    assert torch.equal(ops.ragged_matmul(x, w, 24),
                       ragged_matmul(x, w, capacity=24))
    assert torch.equal(ops.flash_attention(q, k, v),
                       flash_attention(q, k, v, causal=True))
    assert torch.equal(ops.flash_attention(q, k, v, causal=False),
                       flash_attention(q, k, v, causal=False))
    assert torch.equal(ops.paged_attention(*paged), paged_attention(*paged))
    tab = torch.arange(8, dtype=torch.int32)[:, None]
    idx = torch.tensor([1, -1, 9], dtype=torch.int32)
    assert torch.equal(ops.spec_gather(tab, idx), ref.spec_gather(tab, idx))
    vals = torch.ones((3, 1), dtype=torch.int32)
    assert torch.equal(ops.spec_scatter_add(tab.clone(), idx, vals),
                       ref.spec_scatter_add(tab.clone(), idx, vals))


def test_ops_matches_reference_ops_api():
    """The port's API and ``repro.kernels.ops`` on the same inputs."""
    from repro.kernels import ops as jops
    (x, w), (q, k, v), paged = _small_inputs()
    _close(ops.ragged_matmul(x, w, 24),
           jops.ragged_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                              24), GEMM_TOL)
    _close(ops.flash_attention(q, k, v),
           jops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v))),
           ATTN_TOL)
    _close(ops.paged_attention(*paged),
           jops.paged_attention(*(jnp.asarray(t.numpy()) for t in paged)),
           ATTN_TOL)


@pytest.mark.parametrize("bad", ["dtype-f64", "dtype-mixed", "x-shape",
                                 "w-2d", "capacity-0", "noncontig",
                                 "mixed-device"])
def test_ragged_argument_checks(bad):
    x, w = torch.zeros((2 * 8, 4)), torch.zeros((2, 4, 3))
    cap = 8
    if bad == "dtype-f64":
        x, w = x.double(), w.double()
    elif bad == "dtype-mixed":
        w = w.bfloat16()
    elif bad == "x-shape":
        x = x[:-1]
    elif bad == "w-2d":
        w = w[0]
    elif bad == "capacity-0":
        cap = 0
    elif bad == "noncontig":
        w = torch.zeros((2, 3, 4)).transpose(1, 2)
    elif bad == "mixed-device":
        w = w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ragged_matmul(x, w, capacity=cap)


@pytest.mark.parametrize("bad", ["dtype-f16", "dtype-mixed", "q-3d",
                                 "kv-shape", "head-dim", "no-keys",
                                 "noncontig"])
def test_flash_argument_checks(bad):
    q = k = v = torch.zeros((1, 2, 8, 64))
    if bad == "dtype-f16":
        q = k = v = q.half()
    elif bad == "dtype-mixed":
        v = v.bfloat16()
    elif bad == "q-3d":
        q = q[0]
    elif bad == "kv-shape":
        v = v[:, :, :4]
    elif bad == "head-dim":
        q = k = v = torch.zeros((1, 2, 8, 32))
    elif bad == "no-keys":
        k = v = k[:, :, :0]
    elif bad == "noncontig":
        q = torch.zeros((1, 8, 2, 64)).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["dtype-int", "pt-int64", "seq-2d",
                                 "pt-rows", "pages-heads", "head-dim",
                                 "empty-pool", "no-pages", "noncontig"])
def test_paged_argument_checks(bad):
    q = torch.zeros((2, 4, 64))
    kp = vp = torch.zeros((8, 8, 4, 64))
    pt = torch.zeros((2, 3), dtype=torch.int32)
    seq = torch.ones(2, dtype=torch.int32)
    if bad == "dtype-int":
        q, kp, vp = q.int(), kp.int(), vp.int()
    elif bad == "pt-int64":
        pt = pt.long()
    elif bad == "seq-2d":
        seq = seq[:, None]
    elif bad == "pt-rows":
        pt = pt[:1]
    elif bad == "pages-heads":
        kp = vp = torch.zeros((8, 8, 2, 64))
    elif bad == "head-dim":
        q, kp, vp = q[..., :32].contiguous(), kp[..., :32].contiguous(), \
            vp[..., :32].contiguous()
    elif bad == "empty-pool":
        kp = vp = kp[:0]
    elif bad == "no-pages":
        pt = pt[:, :0]
    elif bad == "noncontig":
        pt = torch.zeros((3, 2), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        paged_attention(q, kp, vp, pt, seq)


def test_bf16_plain_within_bf16_tolerance_of_f32():
    (x, w), (q, k, v), paged = _small_inputs()
    bf = torch.bfloat16
    got = ragged_matmul(x.to(bf), w.to(bf), capacity=24)
    assert got.dtype == bf
    want = ragged_matmul(x, w, capacity=24)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=BF16_TOL,
                               atol=BF16_TOL * want.abs().max().item())
    for causal in (True, False):
        got = flash_attention(q.to(bf), k.to(bf), v.to(bf), causal=causal)
        assert got.dtype == bf
        _close(got.float(), flash_attention(q, k, v, causal=causal).numpy(),
               BF16_TOL)
    pq, kp, vp, pt, seq = paged
    got = paged_attention(pq.to(bf), kp.to(bf), vp.to(bf), pt, seq)
    assert got.dtype == bf
    _close(got.float(), paged_attention(*paged).numpy(), BF16_TOL)


# ---------------------------------------------------------------------------
# host-side planning of the TMA kernels: routes, TMA boxes, tile order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,tq,tk,causal,bq,bk", [
    (3, 300, 300, True, 128, 128), (3, 300, 300, False, 128, 128),
    (2, 130, 50, True, 128, 128), (2, 50, 130, True, 128, 128),
    (2, 1, 77, True, 128, 128), (1, 1000, 700, True, 128, 128),
    (2, 256, 256, True, 128, 128), (2, 333, 200, True, 64, 32),
    (1, 200, 333, True, 128, 128), (1, 200, 333, False, 128, 128)])
def test_flash_tile_schedule_visits_exactly_the_live_key_tiles(
        bh, tq, tk, causal, bq, bk):
    """Every (head, query tile) once, heaviest first, each visiting the
    key tiles that hold a live (row, column) pair and no other."""
    from repro_torch.kernels.flash_attention import tile_schedule
    rows = np.arange(tq)[:, None]
    cols = np.arange(tk)[None, :]
    live = np.broadcast_to(cols < tk, (tq, tk))
    if causal:
        live = live & (cols <= rows + tk - tq)
    sched = tile_schedule(bh, tq, tk, causal, bq, bk)
    q_tiles = -(-tq // bq)
    assert sorted((b, qt) for b, qt, _ in sched) == [
        (b, qt) for b in range(bh) for qt in range(q_tiles)]
    counts = [n for _, _, n in sched]
    assert counts == sorted(counts, reverse=True)
    assert [qt for _, qt, _ in sched[:bh]] == [q_tiles - 1] * bh
    for _, qt, n in sched:
        block = live[qt * bq:(qt + 1) * bq]
        live_tiles = [kt for kt in range(-(-tk // bk))
                      if block[:, kt * bk:(kt + 1) * bk].any()]
        assert live_tiles == list(range(n))


def test_flash_plan_routes_and_tiles():
    from repro_torch.kernels.flash_attention import plan
    bf = torch.bfloat16
    q, k, v, out = (torch.zeros((1, 2, 100, 64), dtype=bf) for _ in range(4))
    assert plan(q, k, v, out) == ("tma", 128, 128)
    f32 = [t.float() for t in (q, k, v, out)]
    assert plan(*f32) == ("tiled", 0, 0)
    off = torch.zeros(2 * 100 * 64 + 1, dtype=bf)[1:].view(1, 2, 100, 64)
    assert off.data_ptr() % 16 == 2
    assert plan(off, k, v, out).route == "tiled"
    assert plan(q, k, v, off).route == "tiled"


@pytest.mark.parametrize("shape,dtype,aligned,want", [
    ((384, 56, 7168, 2048), torch.bfloat16, True, ("tma", 256, 132)),
    ((4, 64, 128, 128), torch.bfloat16, True, ("tma", 128, 4)),
    ((3, 200, 264, 520), torch.bfloat16, True, ("tma", 256, 36)),
    ((1, 8, 8, 8), torch.bfloat16, True, ("tma", 128, 1)),
    ((2, 13, 37, 48), torch.bfloat16, True, ("tiled", 0, 0)),
    ((2, 24, 64, 70), torch.bfloat16, True, ("tiled", 0, 0)),
    ((2, 56, 64, 64), torch.bfloat16, False, ("tiled", 0, 0)),
    ((384, 56, 7168, 2048), torch.float32, True, ("tiled", 0, 0))])
def test_ragged_plan_routes_tiles_and_grid(shape, dtype, aligned, want):
    """tma only for aligned bf16 with D and F multiples of 8 (TMA's
    16-byte strides); its grid is persistent, at most one block an SM."""
    from repro_torch.kernels.ragged_matmul import plan
    assert plan(*shape, dtype, aligned, sm_count=132) == want


def test_cpu_calls_count_no_route():
    (x, w), (q, k, v), _ = _small_inputs()
    before = (dict(ragged_matmul.route_launches),
              dict(flash_attention.route_launches))
    ragged_matmul(x.bfloat16(), w.bfloat16(), capacity=24)
    flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert (ragged_matmul.route_launches,
            flash_attention.route_launches) == before
