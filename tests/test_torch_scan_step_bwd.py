"""The step backward of the SSM scans, on the CPU.

``ref.rwkv6_scan_bwd_step`` and ``ref.mamba_scan_bwd_step`` are the
algorithms of the card's ``step`` backward pairs (``csrc/rwkv6_scan.cu``,
``csrc/mamba_scan.cu``): the inputs the chunked routes refuse (T = 1,
tensors off the 16-byte boundary, Mamba widths off the vector).  They
keep the state entering and the cotangent leaving every unit of 32
tokens, then rebuild each unit's states with the step's own roundings
and walk the unit back alone.  Here they are
held to autograd through the plain loops (``ref.rwkv6_scan``,
``ref.mamba_scan``) at ``tests/test_torch_scan_bwd.py``'s tolerances:

* float32 at ``rtol = 1e-5`` and ``atol = 1e-5 * max(1, max|want|)``;
* bfloat16 inputs against autograd through the bf16 loop at
  ``SCAN_GRAD_TOL`` of the largest gradient and through the loop run in
  float32 on the same values at ``SCAN_GRAD_F32_TOL``;

at T in {1, 2, 15, 16, 17, 33, 64, 65} (on and off the units), in three
decay regimes, from a zero or a carried first state, with and without a
cotangent of the last state, RWKV-6 at two heads of 16 and Mamba at D
in {30, 36, 300} (off the 16-byte vector in both dtypes, a multiple of
it in float32 only, and wider than a block's 256 channels).  Every
gradient must be finite, and every state the units rebuild must be the
loop's bit for bit.

The port's blocks with the plain step backward in place of autograd
through the loop are held to ``jax.grad`` of the reference's
``rwkv6_block`` and ``mamba_block`` in float32 at ``1e-4``, as
``tests/test_torch_scan_bwd.py`` holds the chunked one.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scan_bwd import (B, D, D_RWKV, F32_TOL, GRAD_TOL, H, HD, N,
                                 REGIMES, SCAN_GRAD_F32_TOL, SCAN_GRAD_TOL,
                                 STATES, TS, _autograd, _params, _rand,
                                 _ref_block)
from repro_torch.kernels import ref
from repro_torch.models import ssm

#: (kind, width): RWKV-6's head width, Mamba's channels
WIDTHS = (("rwkv", HD), ("mamba", 30), ("mamba", 36), ("mamba", 300))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs: the plain versions run
    thousands of small operations, and on a machine whose cores other
    processes share, each parallel region of a thread pool waits on
    threads that are not running (a subset of this file took 16x as long
    beside six other test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, width, t, regime, carried, dtype, seed):
    """Seeded inputs of one scan (numpy, then torch): RWKV-6 with H heads
    of ``width``, Mamba with ``width`` channels; decays in the models'
    range, near 0 (a fifth of RWKV's w exactly 0; Mamba's Δ·a at or below
    -20) or near 1."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(  # noqa
        np.float32)
    if kind == "rwkv":
        shape = (B, t, H, width)
        if regime == "model":
            w = 1 / (1 + np.exp(-(rng.standard_normal(shape) + 2)))
        elif regime == "near0":
            w = rng.random(shape) * 1e-3
            w[..., ::5] = 0.0
        else:
            w = 1 - rng.random(shape) * 1e-3
        arrs = [f(*shape, sc=0.5), f(*shape, sc=0.5), f(*shape),
                w.astype(np.float32), f(H, width, sc=0.5),
                f(B, H, width, width, sc=0.3 * carried)]
    else:
        x = rng.standard_normal((B, t, 1))
        if regime == "model":
            delta = np.log1p(np.exp(x - 1))
            a = -np.exp(rng.standard_normal((width, N)) * 0.5)
        elif regime == "near0":
            delta = np.log1p(np.exp(x)) + 2
            a = -(10 + 5 * rng.random((width, N)))
        else:
            delta = rng.random((B, t, 1)) * 1e-4
            a = -(1 + 9 * rng.random((width, N)))
        arrs = [f(B, t, width), delta.astype(np.float32), f(B, t, N),
                f(B, t, N), a.astype(np.float32),
                f(B, width, N, sc=0.3 * carried)]
    ins = [torch.from_numpy(a) for a in arrs]
    n_act = 5 if kind == "rwkv" else 4
    return [a.to(dtype) if i < n_act else a for i, a in enumerate(ins)]


def _fns(kind):
    return ((ref.rwkv6_scan, ref.rwkv6_scan_bwd_step) if kind == "rwkv" else
            (ref.mamba_scan, ref.mamba_scan_bwd_step))


def _case(kind, width, t, regime, carried, last, dtype):
    args = _inputs(kind, width, t, regime, carried, dtype,
                   seed=11 * t + REGIMES.index(regime) + 100 * carried
                   + width)
    plain, step = _fns(kind)
    with torch.no_grad():
        s, y = plain(*args)
    g = torch.Generator().manual_seed(t + width)
    w_s = torch.randn(s.shape, generator=g) if last else None
    w_y = torch.randn(y.shape, generator=g)
    got = step(*args, w_s, w_y.to(y.dtype))
    return args, plain, w_s, w_y, got


@pytest.mark.parametrize("carried,last", STATES)
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind,width", WIDTHS)
def test_step_bwd_matches_autograd_float32(kind, width, t, regime, carried,
                                           last):
    args, plain, w_s, w_y, got = _case(kind, width, t, regime, carried, last,
                                       torch.float32)
    want = _autograd(plain, args, w_s, w_y)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.isfinite(a).all(), i
        atol = F32_TOL * max(1.0, b.abs().max().item())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_TOL,
                                   atol=atol, err_msg=str(i))


@pytest.mark.parametrize("carried,last", STATES)
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind,width", WIDTHS)
def test_step_bwd_bf16_within_the_loops(kind, width, t, regime, carried,
                                        last):
    args, plain, w_s, w_y, got = _case(kind, width, t, regime, carried, last,
                                       torch.bfloat16)
    loop = _autograd(plain, args, w_s, w_y)
    f32 = _autograd(plain, args, w_s, w_y, f32=True)
    for i, (a, b, c) in enumerate(zip(got, loop, f32)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= SCAN_GRAD_TOL * b.float().abs().max().item() + 1e-30, (
            i, err)
        # the step pairs keep the bf16 loop's roundings (dC takes the
        # state rounded to bf16), so where the bf16 loop itself lies
        # further than SCAN_GRAD_F32_TOL from the float32 loop (a zero
        # first state at D = 300: its own dC is 0.059 of the largest off)
        # they may lie as far as it does
        own = (b.float() - c).abs().max().item()
        err = (a.float() - c).abs().max().item()
        allow = SCAN_GRAD_F32_TOL * c.abs().max().item() + own
        assert err <= allow + 1e-30, (i, err, own)


def _loop_states(kind, args):
    """The loop's state before every step: the loop run one token at a
    time from the carried state."""
    plain, _ = _fns(kind)
    out, s = [], args[5]
    for i in range(args[0].shape[1]):
        out.append(s)
        s, _ = plain(*(a[:, i:i + 1] for a in args[:4]), args[4], s)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind,width", [("rwkv", HD), ("mamba", 30)])
def test_step_bwd_rebuilds_the_loops_states(kind, width, t, regime, dtype):
    """Every state the units rebuild (S_{t-1} of each step, in order) is
    the loop's bit for bit."""
    args = _inputs(kind, width, t, regime, True, dtype, seed=5 * t + 1)
    _, step = _fns(kind)
    kept = []
    dy = torch.zeros(args[0].shape, dtype=dtype)
    step(*args, None, dy, keep=kept)
    want = _loop_states(kind, args)
    assert len(kept) == len(want) == t
    for i, (a, b) in enumerate(zip(kept, want)):
        assert torch.equal(a, b), i


# ---------------------------------------------------------------------------
# the blocks through the plain step backward against jax.grad
# ---------------------------------------------------------------------------


class _StepGrad(torch.autograd.Function):
    """A scan whose forward is the plain loop and whose backward is the
    plain step backward: the card's step pairs' algorithm inside a
    block."""

    @staticmethod
    def forward(ctx, kind, *args):
        ctx.kind = kind
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return _fns(kind)[0](*args)

    @staticmethod
    def backward(ctx, ds, dy):
        args = ctx.saved_tensors
        dy = torch.zeros(args[0].shape, dtype=args[0].dtype) if dy is None \
            else dy
        return (None, *_fns(ctx.kind)[1](*args, ds, dy))


@pytest.mark.parametrize("t", [9, 70])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_with_step_bwd_matches_reference_grad(kind, t, monkeypatch):
    """float32: ``jax.grad`` of a seeded weighting of the reference
    block's outputs and last state, with respect to every parameter, the
    input and the carried state, against autograd through the port's
    block whose scan differentiates by the plain step backward (T = 70
    crosses two units)."""
    rng = np.random.default_rng(47 + t)
    raw = _params(kind, rng)
    d = D_RWKV if kind == "rwkv" else D
    x = _rand(rng, B, t, d)
    if kind == "rwkv":
        jstate = (jnp.asarray(_rand(rng, B, H, HD, HD, scale=0.3)),
                  jnp.asarray(_rand(rng, B, d)))
    else:
        jstate = jnp.asarray(_rand(rng, B, d, N, scale=0.3))
    w_y = _rand(rng, B, t, d)
    leaves = jax.tree.leaves(jstate)
    w_s = [_rand(rng, *np.shape(a)) for a in leaves]

    def ref_loss(p, x, st):
        y, st_out = _ref_block(kind, p, x, st)
        out = (y * w_y).sum()
        for a, w in zip(jax.tree.leaves(st_out), w_s):
            out = out + (a.astype(jnp.float32) * w).sum()
        return out

    gp, gx, gs = jax.grad(ref_loss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(x), jstate)
    name = "_rwkv6_scan" if kind == "rwkv" else "_mamba_scan"
    monkeypatch.setattr(ssm, name, lambda *a: _StepGrad.apply(kind, *a))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in raw.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tstate = [torch.from_numpy(np.array(a)).requires_grad_(True)
              for a in leaves]
    if kind == "rwkv":
        y, st_out = ssm.rwkv6_block(tp, tx, n_heads=H, head_dim=HD,
                                    state=tuple(tstate), return_state=True)
        outs = list(st_out)
    else:
        y, st_out = ssm.mamba_block(tp, tx, d_state=N, state=tstate[0],
                                    return_state=True)
        outs = [st_out]
    loss = (y * torch.from_numpy(w_y)).sum() + sum(
        (a.float() * torch.from_numpy(w)).sum() for a, w in zip(outs, w_s))
    loss.backward()
    for k, g in gp.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for got, want in zip(tstate, jax.tree.leaves(gs)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


#: a float32 Mamba draw at T = 1 (B 2, 8192 channels, the models' decay
#: regime) on which chip_smoke.py's step-pair sweep once held the pair's
#: du to the float32 loop at SCAN_GRAD_TOL's 1e-4 of max|du| and failed:
#: phase_scan's seed-25 generator at Philox offset 12388 (``generator``),
#: drawn with the step forward sweep sharing it, and y's cotangent from
#: seed 8, without one of the last state.  B·C cancels in the first batch
#: (9.4e-6 against 10.6 of its terms), so du there is a cancelled sum.
DU_DRAW = os.path.join(os.path.dirname(__file__), "data",
                       "mamba_du_t1_draw.npz")
#: the share of max|du| by which the pair's du may lie farther from the
#: loop in float64 than the float32 loop's (test_torch_cuda.py's
#: DU_F64_MARGIN, the atol of SCAN_GRAD_TOL[float32])
DU_F64_MARGIN = 1e-4


def _du(fn, args, dy):
    """du of ``fn``'s scan through autograd, given y's cotangent and none
    of the last state, in the inputs' dtype."""
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    _, y = fn(*xs)
    return torch.autograd.grad([y], xs[0], [dy.to(y.dtype)])[0]


def test_mamba_step_du_on_the_cancelling_draw_against_float64():
    """The plain order version's du (``ref.mamba_scan_bwd_step``, the step
    pair's algorithm) on the saved draw is no farther from the loop in
    float64 than the float32 loop's is, plus 1e-4 of max|du| (the relation
    the card test holds the pair to).  Prints both distances: the float32
    loop's own lies near 1e-4 of max|du| on this draw, a rounding of the
    CPU's float32 sums, so it is a reading and not a check."""
    z = np.load(DU_DRAW)
    args = [torch.from_numpy(z[k]) for k in ("u", "delta", "bmat", "cmat",
                                              "a", "s0")]
    dy = torch.from_numpy(z["dy"])
    bc = (z["bmat"] * z["cmat"]).sum(-1).ravel()
    assert abs(bc[0]) < 1e-5 * np.abs(z["bmat"] * z["cmat"]).sum(-1)[0, 0]
    wide = _du(ref.mamba_scan, [a.double() for a in args], dy)
    loop = _du(ref.mamba_scan, args, dy)
    plain = ref.mamba_scan_bwd_step(*args, None, dy)[0]
    big = wide.abs().max().item()
    np.testing.assert_allclose(big, 8.6665e-3, rtol=1e-4)
    d_loop = (loop.double() - wide).abs().max().item()
    d_plain = (plain.double() - wide).abs().max().item()
    print(f"du against float64: plain order {d_plain:.4g}, float32 loop "
          f"{d_loop:.4g}, 1e-4 of max|du| {DU_F64_MARGIN * big:.4g}")
    assert d_plain <= d_loop + DU_F64_MARGIN * big, (d_plain, d_loop, big)
