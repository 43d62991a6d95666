"""The chunked backward of the SSM scans, on the CPU.

``ref.rwkv6_scan_bwd_chunked`` and ``ref.mamba_scan_bwd_chunked`` are
the algorithms of the card's ``chunked`` (RWKV-6,
``csrc/rwkv6_chunk_bwd_sm90.cu``) and ``chunk`` (Mamba, in
``csrc/mamba_scan.cu``) backward routes: the state entering and the
cotangent leaving every 64 tokens, then each unit alone.  Here they are
held to autograd through the plain loops (``ref.rwkv6_scan``,
``ref.mamba_scan``), the yardstick of every backward:

* float32 at ``rtol = 1e-5`` and ``atol = 1e-5 * max(1, max|want|)``:
  the same gradients summed in another order (near 1 the state remembers
  every token, a gradient's terms reach 100, and float32 sums of them in
  another order differ by up to 2.5e-5 where the sum is near 0);
* bfloat16 inputs (the plain chunked versions compute in float32 on the
  bf16 values and round once) against autograd through the bf16 loop at
  ``SCAN_GRAD_TOL`` of the largest gradient (autograd rounds every step's
  terms to bf16) and through the loop run in float32 on the same values
  at ``SCAN_GRAD_F32_TOL``;

at T in {1, 2, 15, 16, 17, 33, 64, 65} (T off the chunk of 16 and the unit
of 64), in three decay regimes (the models' own; near 0 with a fifth of
RWKV's w exactly 0 and Mamba's Δ·a at or below -20, where exp(Δ·a)
underflows; near 1), from a zero or a carried first state, with and
without a cotangent of the last state.  Every gradient must be finite.

The port's blocks with the chunked plain backward in place of autograd
through the loop are held to ``jax.grad`` of the reference's
``rwkv6_block`` and ``mamba_block`` in float32 at ``1e-4``, as
``tests/test_torch_scan.py`` holds the loop.  The backward plans are
pure functions of dtype, shape and alignment, checked here on CPU
tensors, which count no backward launch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro_torch.kernels import ops, ref, scan
from repro_torch.models import ssm

B, H, HD, D, N = 2, 2, 16, 24, 16
#: float32 against autograd through the float32 loop: rtol, and atol
#: as a share of max(1, max|want|)
F32_TOL = 1e-5
#: bf16 against autograd through the bf16 loop, as a share of the
#: largest gradient (chip_smoke.py's SCAN_GRAD_TOL)
SCAN_GRAD_TOL = 2.0 ** -3
#: bf16 against autograd through the loop in float32 on the same values,
#: as a share of the largest gradient (chip_smoke.py's SCAN_GRAD_F32_TOL)
SCAN_GRAD_F32_TOL = 2.0 ** -6
#: the blocks' gradients against the reference's: rtol = atol
GRAD_TOL = 1e-4
TS = (1, 2, 15, 16, 17, 33, 64, 65)
REGIMES = ("model", "near0", "near1")
#: (carried first state, cotangent of the last state)
STATES = ((False, True), (True, False), (True, True))


def _inputs(kind, t, regime, carried, dtype, seed):
    """Seeded inputs of one scan (numpy, then torch)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(  # noqa
        np.float32)
    if kind == "rwkv":
        shape = (B, t, H, HD)
        if regime == "model":
            w = 1 / (1 + np.exp(-(rng.standard_normal(shape) + 2)))
        elif regime == "near0":
            w = rng.random(shape) * 1e-3
            w[..., ::5] = 0.0
        else:
            w = 1 - rng.random(shape) * 1e-3
        arrs = [f(*shape, sc=0.5), f(*shape, sc=0.5), f(*shape),
                w.astype(np.float32), f(H, HD, sc=0.5),
                f(B, H, HD, HD, sc=0.3 * carried)]
    else:
        x = rng.standard_normal((B, t, 1))
        if regime == "model":
            delta = np.log1p(np.exp(x - 1))
            a = -np.exp(rng.standard_normal((D, N)) * 0.5)
        elif regime == "near0":
            delta = np.log1p(np.exp(x)) + 2
            a = -(10 + 5 * rng.random((D, N)))
        else:
            delta = rng.random((B, t, 1)) * 1e-4
            a = -(1 + 9 * rng.random((D, N)))
        arrs = [f(B, t, D), delta.astype(np.float32), f(B, t, N), f(B, t, N),
                a.astype(np.float32), f(B, D, N, sc=0.3 * carried)]
    ins = [torch.from_numpy(a) for a in arrs]
    # the activations (and RWKV's u) in dtype; the state and A float32
    n_act = 5 if kind == "rwkv" else 4
    return [a.to(dtype) if i < n_act else a for i, a in enumerate(ins)]


def _autograd(plain, args, w_s, w_y, f32=False):
    xs = [(a.float() if f32 else a.clone()).requires_grad_(True)
          for a in args]
    s, y = plain(*xs)
    loss = (y.float() * w_y).sum()
    if w_s is not None:
        loss = loss + (s * w_s).sum()
    loss.backward()
    # an input that y and the kept state do not reach (w at T = 1 with no
    # cotangent of the last state) has no gradient: zeros
    return [torch.zeros_like(x) if x.grad is None else x.grad for x in xs]


def _case(kind, t, regime, carried, last, dtype):
    args = _inputs(kind, t, regime, carried, dtype,
                   seed=7 * t + REGIMES.index(regime) + 100 * carried)
    plain, chunked = ((ref.rwkv6_scan, ref.rwkv6_scan_bwd_chunked)
                      if kind == "rwkv" else
                      (ref.mamba_scan, ref.mamba_scan_bwd_chunked))
    with torch.no_grad():
        s, y = plain(*args)
    g = torch.Generator().manual_seed(t)
    w_s = torch.randn(s.shape, generator=g) if last else None
    w_y = torch.randn(y.shape, generator=g)
    got = chunked(*args, w_s, w_y.to(y.dtype))
    return args, plain, w_s, w_y, got


@pytest.mark.parametrize("carried,last", STATES)
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_chunked_bwd_matches_autograd_float32(kind, t, regime, carried,
                                              last):
    args, plain, w_s, w_y, got = _case(kind, t, regime, carried, last,
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
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_chunked_bwd_bf16_within_the_loops(kind, t, regime, carried, last):
    args, plain, w_s, w_y, got = _case(kind, t, regime, carried, last,
                                       torch.bfloat16)
    loop = _autograd(plain, args, w_s, w_y)
    f32 = _autograd(plain, args, w_s, w_y, f32=True)
    for i, (a, b, c) in enumerate(zip(got, loop, f32)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= SCAN_GRAD_TOL * b.float().abs().max().item() + 1e-30, (
            i, err)
        err = (a.float() - c).abs().max().item()
        assert err <= SCAN_GRAD_F32_TOL * c.abs().max().item() + 1e-30, (
            i, err)


def test_chunked_bwd_checks_its_split():
    args = _inputs("rwkv", 5, "model", False, torch.float32, 1)
    dy = torch.zeros(args[0].shape)
    with pytest.raises(ValueError, match="multiple"):
        ref.rwkv6_scan_bwd_chunked(*args, None, dy, chunk=16, unit=40)


# ---------------------------------------------------------------------------
# the blocks through the chunked plain backward against jax.grad
# ---------------------------------------------------------------------------


class _ChunkedGrad(torch.autograd.Function):
    """A scan whose forward is the plain loop and whose backward is the
    plain chunked one: the card's routes' algorithm inside a block."""

    @staticmethod
    def forward(ctx, kind, *args):
        ctx.kind = kind
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return (ref.rwkv6_scan if kind == "rwkv" else ref.mamba_scan)(*args)

    @staticmethod
    def backward(ctx, ds, dy):
        args = ctx.saved_tensors
        dy = torch.zeros(args[0].shape, dtype=args[0].dtype) if dy is None \
            else dy
        fn = (ref.rwkv6_scan_bwd_chunked if ctx.kind == "rwkv" else
              ref.mamba_scan_bwd_chunked)
        return (None, *fn(*args, ds, dy))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


#: the RWKV-6 block's width: H heads of HD
D_RWKV = H * HD


def _params(kind, rng):
    if kind == "rwkv":
        d = D_RWKV
        return {"mu": rng.random((4, d)).astype(np.float32),
                "wr": _rand(rng, d, d, scale=0.2),
                "wk": _rand(rng, d, d, scale=0.2),
                "wv": _rand(rng, d, d, scale=0.2),
                "ww": _rand(rng, d, d, scale=0.1),
                "w_bias": _rand(rng, d, scale=0.5) + 1.0,
                "u": _rand(rng, d, scale=0.5),
                "wo": _rand(rng, d, d, scale=0.1)}
    return {"in_proj": _rand(rng, D, D, scale=0.2),
            "gate_proj": _rand(rng, D, D, scale=0.1),
            "dt_proj": _rand(rng, D, scale=0.1),
            "b_proj": _rand(rng, D, N, scale=0.2),
            "c_proj": _rand(rng, D, N, scale=0.2),
            "a_log": _rand(rng, D, N, scale=0.5),
            "out_proj": _rand(rng, D, D, scale=0.1)}


def _ref_block(kind, p, x, st):
    if kind == "rwkv":
        return rssm.rwkv6_block(p, x, n_heads=H, head_dim=HD, state=st,
                                return_state=True)
    return rssm.mamba_block(p, x, d_state=N, state=st, return_state=True)


@pytest.mark.parametrize("t", [9, 70])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_with_chunked_bwd_matches_reference_grad(kind, t, monkeypatch):
    """float32: ``jax.grad`` of a seeded weighting of the reference
    block's outputs and last state, with respect to every parameter, the
    input and the carried state, against autograd through the port's
    block whose scan differentiates by the plain chunked backward."""
    rng = np.random.default_rng(31 + t)
    raw = _params(kind, rng)
    d = D_RWKV if kind == "rwkv" else D
    x = _rand(rng, B, t, d)
    if kind == "rwkv":
        jstate = (jnp.asarray(_rand(rng, B, H, HD, HD, scale=0.3)),
                  jnp.asarray(_rand(rng, B, d)))
    else:
        jstate = jnp.asarray(_rand(rng, B, D, N, scale=0.3))
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
    monkeypatch.setattr(ssm, name,
                        lambda *a: _ChunkedGrad.apply(kind, *a))
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


# ---------------------------------------------------------------------------
# the backward plans
# ---------------------------------------------------------------------------


def _offset(t: torch.Tensor) -> torch.Tensor:
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _plan_args(kind, t, dtype, d=64):
    args = _inputs(kind, t, "model", True, dtype, 3) if d == 64 or \
        kind == "rwkv" else None
    if kind == "mamba" and d != 64:
        g = torch.Generator().manual_seed(t)
        args = [torch.randn(B, t, d, generator=g).to(dtype),
                torch.rand(B, t, 1, generator=g).to(dtype),
                torch.randn(B, t, N, generator=g).to(dtype),
                torch.randn(B, t, N, generator=g).to(dtype),
                -torch.rand(d, N, generator=g),
                torch.randn(B, d, N, generator=g)]
    with torch.no_grad():
        s, y = (ref.rwkv6_scan if kind == "rwkv" else ref.mamba_scan)(*args)
    return args, torch.randn(s.shape), torch.randn(y.shape).to(dtype)


@pytest.mark.parametrize("dtype,t,want", [
    (torch.bfloat16, 1, "step"), (torch.bfloat16, 2, "chunked"),
    (torch.bfloat16, 65, "chunked"), (torch.float32, 2, "step"),
    (torch.float32, 65, "step")])
def test_rwkv6_bwd_plan_routes_by_dtype_and_t(dtype, t, want):
    args, ds, dy = _plan_args("rwkv", t, dtype)
    assert scan.rwkv6_bwd_plan(*args, ds, dy) == want
    assert scan.rwkv6_bwd_plan(*args, None, dy) == want


@pytest.mark.parametrize("which", ["r", "w", "s", "ds", "dy"])
def test_rwkv6_bwd_plan_takes_unaligned_tensors_by_step(which):
    args, ds, dy = _plan_args("rwkv", 5, torch.bfloat16)
    i = {"r": 0, "w": 3, "s": 5}.get(which)
    if i is not None:
        args[i] = _offset(args[i])
    ds = _offset(ds) if which == "ds" else ds
    dy = _offset(dy) if which == "dy" else dy
    assert scan.rwkv6_bwd_plan(*args, ds, dy) == "step"


@pytest.mark.parametrize("dtype,t,d,want", [
    (torch.bfloat16, 1, 64, "step"), (torch.bfloat16, 2, 64, "chunk"),
    (torch.bfloat16, 65, 64, "chunk"), (torch.bfloat16, 9, 300, "step"),
    (torch.float32, 9, 64, "step")])
def test_mamba_bwd_plan_routes_by_dtype_t_and_width(dtype, t, d, want):
    args, ds, dy = _plan_args("mamba", t, dtype, d)
    assert scan.mamba_bwd_plan(*args, ds, dy) == want


@pytest.mark.parametrize("which", ["u", "bmat", "dy"])
def test_mamba_bwd_plan_takes_unaligned_tensors_by_step(which):
    args, ds, dy = _plan_args("mamba", 9, torch.bfloat16)
    i = {"u": 0, "bmat": 2}.get(which)
    if i is not None:
        args[i] = _offset(args[i])
    dy = _offset(dy) if which == "dy" else dy
    assert scan.mamba_bwd_plan(*args, ds, dy) == "step"


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_cpu_backward_counts_no_route(kind):
    """A CPU tensor's gradient is autograd's through the plain loop: no
    backward launch counted, by any route."""
    fn, wrapper = ((ops.rwkv6_scan, scan.rwkv6_scan) if kind == "rwkv" else
                   (ops.mamba_scan, scan.mamba_scan))
    args = [a.requires_grad_(True) for a in
            _inputs(kind, 17, "model", True, torch.bfloat16, 5)]
    before = dict(wrapper.bwd_route_launches), wrapper.bwd_launches
    s, y = fn(*args)
    (y.float().sum() + s.sum()).backward()
    assert all(a.grad is not None for a in args)
    assert (dict(wrapper.bwd_route_launches), wrapper.bwd_launches) == before
    assert set(wrapper.bwd_route_launches) == set(
        scan.RWKV6_BWD_ROUTES if kind == "rwkv" else scan.MAMBA_BWD_ROUTES)
