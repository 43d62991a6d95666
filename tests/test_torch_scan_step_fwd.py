"""The step forwards of the SSM scans at T >= 2, on the CPU.

The card's step routes (the inputs the chunked routes refuse: T = 1,
tensors off the 16-byte boundary, Mamba's widths off the vector) keep the
loop's roundings, so their last state is the loop's bit for bit; only
their read-out's sums run in their own order.  ``ref.rwkv6_scan_step``
and ``ref.mamba_scan_step`` are the plain versions that sum y in that
order (``rwkv6_step_fwd_kernel``: eight row lanes of hd / 8 rows, each a
chain of fused multiply-adds, meeting in a fixed tree;
``mamba_fwd_kernel``: one chain over the N state values), with
``ref.fma32`` for the card's single-rounding ``fmaf``.  On the card,
``tests/test_torch_cuda.py`` (``-k step_fwd``) holds the kernels' y to
them bit for bit.  Here they are held

* to the plain loops (``ref.rwkv6_scan``, ``ref.mamba_scan``): the last
  state bitwise, y within ``SCAN_TOL`` (rtol, and atol as a share of the
  largest: float32 ``1e-5``, bfloat16 one bf16 ulp, ``2**-7``), at T in
  {1, 2, 15, 16, 17, 33, 64, 65}, RWKV-6 head widths 16 and 64, Mamba
  widths 30 and 300, both dtypes and three decay regimes;
* to the reference's ``lax.scan`` inside its ``rwkv6_block`` (recorded
  as ``tests/test_torch_scan.py`` records it) at that file's tolerances,
  rtol and atol as a share of the largest value: the last state at
  ``1e-6``, float32 y at ``1e-5``, bfloat16 y within one bf16 ulp
  (``2**-7``).  (That file's absolute ``1e-6`` and ``1e-5`` hold at its
  T <= 9; at T = 33 and one head of 64 the loop's own float32 y lies
  4.6e-5 from the reference's, where y reaches 238, and its state 1.9e-6,
  XLA fusing the update's multiply-add on the CPU);
* and ``ref.fma32`` to one rounding of the exact ``a * b + c``, where
  rounding the float64 sum to float32 would round twice.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro_torch.kernels import ref

#: y against the loop: rtol, and atol as a share of max|want|
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: against the reference's scan (tests/test_torch_scan.py's values): float32
#: y and the last state, rtol, and atol as a share of max|want|
F32_TOL, STATE_TOL = 1e-5, 1e-6
TS = (1, 2, 15, 16, 17, 33, 64, 65)
REGIMES = ("model", "near0", "near1")
DTYPES = (torch.float32, torch.bfloat16)
#: the reference block's width (heads of 16 or one head of 64), batch
D, B = 64, 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain versions run many small operations
    (as in tests/test_torch_scan_step_bwd.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, width, t, regime, dtype, seed):
    """Seeded inputs (numpy, then torch): RWKV-6 with two heads of
    ``width``, Mamba with ``width`` channels and N = 16; decays in the
    models' range, near 0 (a fifth of RWKV's w exactly 0; Mamba's Δ·a at
    or below -20) or near 1; a carried first state."""
    rng = np.random.default_rng(seed)

    def f(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    if kind == "rwkv":
        shape = (B, t, 2, width)
        if regime == "model":
            w = 1 / (1 + np.exp(-(rng.standard_normal(shape) + 2)))
        elif regime == "near0":
            w = rng.random(shape) * 1e-3
            w[..., ::5] = 0.0
        else:
            w = 1 - rng.random(shape) * 1e-3
        arrs = [f(*shape, sc=0.5), f(*shape, sc=0.5), f(*shape),
                w.astype(np.float32), f(2, width, sc=0.5),
                f(B, 2, width, width, sc=0.3)]
        n_act = 5
    else:
        x = rng.standard_normal((B, t, 1))
        if regime == "model":
            delta = np.log1p(np.exp(x - 1))
            a = -np.exp(rng.standard_normal((width, 16)) * 0.5)
        elif regime == "near0":
            delta = np.log1p(np.exp(x)) + 2
            a = -(10 + 5 * rng.random((width, 16)))
        else:
            delta = rng.random((B, t, 1)) * 1e-4
            a = -(1 + 9 * rng.random((width, 16)))
        arrs = [f(B, t, width), delta.astype(np.float32), f(B, t, 16),
                f(B, t, 16), a.astype(np.float32), f(B, width, 16, sc=0.3)]
        n_act = 4
    ins = [torch.from_numpy(a) for a in arrs]
    return [a.to(dtype) if i < n_act else a for i, a in enumerate(ins)]


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    atol = tol * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind,width", [("rwkv", 16), ("rwkv", 64),
                                        ("mamba", 30), ("mamba", 300)])
def test_step_order_matches_the_loop(kind, width, t, dtype, regime):
    args = _inputs(kind, width, t, regime, dtype,
                   seed=7 * t + width + REGIMES.index(regime))
    plain, order = ((ref.rwkv6_scan, ref.rwkv6_scan_step) if kind == "rwkv"
                    else (ref.mamba_scan, ref.mamba_scan_step))
    ws, wy = plain(*args)
    s, y = order(*args)
    assert s.dtype == torch.float32 and y.dtype == dtype
    assert torch.equal(s, ws)
    _close(y, wy, SCAN_TOL[dtype])


def test_step_order_sums_rows_in_lanes():
    """y of one token is the tree of the row lanes' chains: a one-hot r
    picks one row of M, so y is that row bit for bit, whatever the lane;
    and with r and M ones, each lane's chain counts its rows exactly."""
    hd = 64
    for i in (0, 7, 8, 33, 63):
        r = torch.zeros(1, 1, 1, hd)
        r[..., i] = 1.0
        k, v = torch.randn(1, 1, 1, hd), torch.randn(1, 1, 1, hd)
        w, u = torch.rand(1, 1, 1, hd), torch.randn(1, hd)
        s = torch.randn(1, 1, hd, hd)
        _, y = ref.rwkv6_scan_step(r, k, v, w, u, s)
        m = s + u[None, :, :, None] * (k[0, 0, :, :, None] * v[0, 0, :, None])
        assert torch.equal(y[0, 0, 0], m[0, 0, i])
    _, y = ref.rwkv6_scan_step(torch.ones(1, 1, 1, hd), torch.zeros(
        1, 1, 1, hd), torch.zeros(1, 1, 1, hd), torch.ones(1, 1, 1, hd),
        torch.zeros(1, hd), torch.ones(1, 1, hd, hd))
    assert torch.equal(y, torch.full((1, 1, 1, hd), float(hd)))


def test_fma32_rounds_once():
    """``fma32`` is ``fmaf``: one rounding of the exact a * b + c.  Where
    the exact sum lies just below a float32 halfway point that float64
    rounds onto, the float64 sum rounded again to float32 goes the wrong
    way; ``fma32`` does not.  Elsewhere it agrees with that double
    rounding (which is right but for such ties)."""
    f = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    one = 1 + 2 ** -23
    for sign in (1.0, -1.0):
        a, b, c = f(one), f(sign * 2 ** -24 * (1 - 2 ** -23)), f(sign * one)
        twice = (a.double() * b.double() + c.double()).float()
        assert twice.item() == sign * (1 + 2 ** -22)
        assert ref.fma32(a, b, c).item() == sign * one
    rng = np.random.default_rng(3)
    x, y, z = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
               for _ in range(3))
    want = (x.double() * y.double() + z.double()).float()
    assert torch.equal(ref.fma32(x, y, z), want)
    # zeros keep IEEE signs: (-0) * 1 + (+0) is +0
    zero = ref.fma32(f(-0.0), f(1.0), f(0.0))
    assert zero.item() == 0.0 and not torch.signbit(zero).item()


# ---------------------------------------------------------------------------
# against the reference's lax.scan
# ---------------------------------------------------------------------------


def _t(a):
    """numpy (float32 or ml_dtypes bf16) -> the same torch bits."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _recorded_rwkv6(hd, dtype, t, seed, monkeypatch):
    """The reference ``rwkv6_block``'s ``lax.scan`` at width D in heads of
    ``hd``, from a carried state: (the port's six scan inputs, the
    reference's last state and outputs, batch-major)."""
    rng = np.random.default_rng(seed)
    h = D // hd

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"mu": rng.random((4, D)).astype(np.float32),
              "wr": rnd(D, D, scale=0.2), "wk": rnd(D, D, scale=0.2),
              "wv": rnd(D, D, scale=0.2), "ww": rnd(D, D, scale=0.1),
              "w_bias": rnd(D, scale=0.5) + 1.0, "u": rnd(D, scale=0.5),
              "wo": rnd(D, D, scale=0.1)}
    x = rnd(B, t, D)
    if dtype == "bfloat16":
        params = {k: v.astype(ml_dtypes.bfloat16) for k, v in params.items()}
        x = x.astype(ml_dtypes.bfloat16)
    state = (jnp.asarray(rnd(B, h, hd, hd, scale=0.3)),
             jnp.asarray(rnd(B, D)))
    calls = []
    real = jax.lax.scan

    def recording(f, init, xs, *args, **kw):
        carry, ys = real(f, init, xs, *args, **kw)
        calls.append((f, init, xs, carry, ys))
        return carry, ys

    monkeypatch.setattr(jax.lax, "scan", recording)
    rssm.rwkv6_block({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x), n_heads=h, head_dim=hd, state=state,
                     return_state=True)
    monkeypatch.undo()
    (step, init, xs, carry, ys), = calls
    closed = dict(zip(step.__code__.co_freevars,
                      (c.cell_contents for c in step.__closure__)))
    xs = [np.swapaxes(np.asarray(a), 0, 1) for a in xs]
    ins = [_t(a) for a in xs] + [_t(np.asarray(closed["u"])),
                                 _t(np.asarray(init))]
    return ins, np.asarray(carry), np.swapaxes(np.asarray(ys), 0, 1)


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_step_order_matches_reference_scan(hd, dtype, t, monkeypatch):
    ins, carry, ys = _recorded_rwkv6(hd, dtype, t, 29 + t + hd, monkeypatch)
    s, y = ref.rwkv6_scan_step(*ins)
    _close(s, torch.from_numpy(carry), STATE_TOL)
    assert tuple(y.shape) == ys.shape
    _close(y, torch.from_numpy(ys.astype(np.float32)),
           F32_TOL if dtype == "float32" else SCAN_TOL[torch.bfloat16])
