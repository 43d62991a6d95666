"""The chunked form of the RWKV-6 scan, and the scans' route plans, on the
CPU.

``ref.rwkv6_scan_chunked`` is the algorithm of the card's ``chunked``
route (``csrc/rwkv6_chunk_sm90.cu``): the state carried once a chunk,
the decays as direct products of w, the chunk's own tokens through
float32 scores.  Here it is held to the reference's own ``lax.scan``
step: the step is recorded from ``repro.models.ssm.rwkv6_block`` (it
closes over u) and run by ``jax.lax.scan`` over seeded numpy inputs, in
float32, at T = 1, across the chunk boundaries (15, 16, 17, 63, 64, 65)
and at T = 200, from a zero and from a carried state, in three decay
regimes: the models' own (``sigmoid(x + 2)``), near 0 (w <= 1e-3, a
fifth of the channels exactly 0) and near 1 (w >= 0.999).  The kernel's
configuration (chunks of 16, ``chunk = sub = 16``) and the two-level
form (chunks of 64 in sub-chunks of 16, the cross-sub-chunk decays split
at the sub-chunk's start) both hold at ``rtol = 1e-5`` and ``atol = 1e-5
* max|want|``: float32 sums taken in another order.  Every output must be
finite.

The route plans (``scan.rwkv6_plan``, ``scan.mamba_plan``) are pure
functions of dtype, shape and alignment, so they are checked here on CPU
tensors; a CPU tensor still runs the plain loop and counts no launch.
Prefill in either dtype takes the chunked routes (float32 since the
float32 entries were added); T = 1, unaligned tensors and Mamba's widths
off the 16-byte vector (8 bf16, 4 float32 values) go by step.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro_torch.kernels import ops, ref, scan

B, H, HD = 2, 2, 16
D = H * HD
#: the chunked form against the reference scan: rtol, and atol as a share
#: of max|want| (float32 reassociation)
TOL = 1e-5
TS = (1, 15, 16, 17, 63, 64, 65, 200)
REGIMES = ("model", "near0", "near1")
#: (chunk, sub): the kernel's, and chunks of 64 in sub-chunks of 16
FORMS = ((16, 16), (64, 16))


@functools.lru_cache(maxsize=None)
def _step():
    """The reference block's scan step (float32) and the u it closes
    over, recorded from one call of ``rwkv6_block``."""
    rng = np.random.default_rng(5)
    f = lambda *s, sc=1.0: jnp.asarray(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32))
    params = {"mu": jnp.asarray(rng.random((4, D)).astype(np.float32)),
              "wr": f(D, D, sc=0.2), "wk": f(D, D, sc=0.2),
              "wv": f(D, D, sc=0.2), "ww": f(D, D, sc=0.1),
              "w_bias": f(D, sc=0.5) + 1.0, "u": f(D, sc=0.5),
              "wo": f(D, D, sc=0.1)}
    calls = []
    real = jax.lax.scan

    def recording(fn, init, xs, *args, **kw):
        calls.append(fn)
        return real(fn, init, xs, *args, **kw)

    jax.lax.scan = recording
    try:
        rssm.rwkv6_block(params, f(B, 3, D), n_heads=H, head_dim=HD)
    finally:
        jax.lax.scan = real
    step, = calls
    closed = dict(zip(step.__code__.co_freevars,
                      (c.cell_contents for c in step.__closure__)))
    return step, np.asarray(closed["u"])


def _decays(rng, shape, regime):
    if regime == "model":
        return 1 / (1 + np.exp(-(rng.standard_normal(shape) + 2)))
    if regime == "near0":
        w = rng.random(shape) * 1e-3
        w[..., ::5] = 0.0
        return w
    return 1 - rng.random(shape) * 1e-3


@functools.lru_cache(maxsize=None)
def _case(t, regime, carried):
    """Seeded float32 inputs (batch-major) and the reference scan's last
    state and outputs on them."""
    rng = np.random.default_rng(100 + t + 7 * REGIMES.index(regime)
                                + 1000 * carried)
    shape = (B, t, H, HD)
    r, k = ((rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    w = _decays(rng, shape, regime).astype(np.float32)
    s0 = (rng.standard_normal((B, H, HD, HD)) * 0.3 * carried).astype(
        np.float32)
    step, u = _step()
    xs = tuple(jnp.asarray(np.swapaxes(a, 0, 1)) for a in (r, k, v, w))
    carry, ys = jax.lax.scan(step, jnp.asarray(s0), xs)
    ins = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    return ins, np.asarray(carry), np.swapaxes(np.asarray(ys), 0, 1)


def _close(got, want):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"chunk{f[0]}_sub{f[1]}")
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("t", TS)
def test_chunked_matches_reference_scan(t, regime, carried, form):
    ins, carry, ys = _case(t, regime, carried)
    s, y = ref.rwkv6_scan_chunked(*ins, chunk=form[0], sub=form[1])
    assert s.dtype == y.dtype == torch.float32
    assert tuple(y.shape) == ys.shape
    _close(s.numpy(), carry)
    _close(y.numpy(), ys)


def test_chunked_rejects_a_ragged_split():
    ins, _, _ = _case(15, "model", False)
    with pytest.raises(ValueError, match="multiple"):
        ref.rwkv6_scan_chunked(*ins, chunk=16, sub=6)


def test_chunked_keeps_the_activations_dtype():
    """bf16 in, bf16 out; the arithmetic is float32 on the bf16 values."""
    ins, _, _ = _case(17, "model", True)
    bf = [a.to(torch.bfloat16) for a in ins[:5]] + [ins[5]]
    s, y = ref.rwkv6_scan_chunked(*bf)
    s32, y32 = ref.rwkv6_scan_chunked(*[a.float() for a in bf])
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(s, s32)
    assert torch.equal(y, y32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# route plans
# ---------------------------------------------------------------------------


def _rwkv(t, dtype, hd=HD):
    g = torch.Generator().manual_seed(t)
    shape = (B, t, H, hd)
    acts = [torch.randn(shape, generator=g).to(dtype) for _ in range(4)]
    return acts + [torch.randn(H, hd, generator=g).to(dtype),
                   torch.randn(B, H, hd, hd, generator=g)]


def _mamba(t, dtype, d=64):
    g = torch.Generator().manual_seed(t)
    return [torch.randn(B, t, d, generator=g).to(dtype),
            torch.rand(B, t, 1, generator=g).to(dtype),
            torch.randn(B, t, 16, generator=g).to(dtype),
            torch.randn(B, t, 16, generator=g).to(dtype),
            -torch.rand(d, 16, generator=g),
            torch.randn(B, d, 16, generator=g)]


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view whose first element sits off a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,t,want", [
    (torch.bfloat16, 1, "step"), (torch.bfloat16, 2, "chunked"),
    (torch.bfloat16, 17, "chunked"), (torch.bfloat16, 512, "chunked"),
    (torch.float32, 1, "step"), (torch.float32, 2, "chunked"),
    (torch.float32, 512, "chunked")])
def test_rwkv6_plan_routes_by_dtype_and_t(dtype, t, want):
    assert scan.rwkv6_plan(*_rwkv(t, dtype)) == want


@pytest.mark.parametrize("hd", scan.HEAD_DIMS)
def test_rwkv6_plan_takes_every_head_width_chunked(hd):
    assert scan.rwkv6_plan(*_rwkv(5, torch.bfloat16, hd)) == "chunked"


@pytest.mark.parametrize("which", [0, 1, 2, 3, 5])
def test_rwkv6_plan_takes_unaligned_tensors_by_step(which):
    args = _rwkv(5, torch.bfloat16)
    args[which] = _offset(args[which])
    assert scan.rwkv6_plan(*args) == "step"


@pytest.mark.parametrize("dtype,t,want", [
    (torch.bfloat16, 1, "decode"), (torch.float32, 1, "decode"),
    (torch.bfloat16, 2, "chunk"), (torch.bfloat16, 33, "chunk"),
    (torch.float32, 2, "chunk"), (torch.float32, 33, "chunk")])
def test_mamba_plan_routes_by_dtype_and_t(dtype, t, want):
    assert scan.mamba_plan(*_mamba(t, dtype)) == want


@pytest.mark.parametrize("t,which,want", [
    (1, 2, "step"), (1, 4, "step"), (1, 5, "step"), (1, 0, "decode"),
    (9, 0, "step"), (9, 3, "step")])
def test_mamba_plan_takes_unaligned_vectors_by_step(t, which, want):
    """The new routes read B, C, A and the state (the chunk route u too)
    as 16-byte vectors; decode reads u and delta element by element."""
    args = _mamba(t, torch.bfloat16)
    args[which] = _offset(args[which])
    assert scan.mamba_plan(*args) == want


def test_mamba_plan_takes_ragged_channels_by_step():
    assert scan.mamba_plan(*_mamba(9, torch.bfloat16, d=300)) == "step"
    assert scan.mamba_plan(*_mamba(1, torch.bfloat16, d=300)) == "decode"


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 36, "chunk"), (torch.bfloat16, 36, "step"),
    (torch.float32, 300, "chunk"), (torch.float32, 30, "step"),
    (torch.float32, 8, "chunk"), (torch.bfloat16, 8, "chunk")])
def test_mamba_plan_width_rule(dtype, d, want):
    """The chunk route moves u and y as 16-byte vectors: D a multiple of
    4 in float32, of 8 in bfloat16."""
    assert scan.mamba_plan(*_mamba(9, dtype, d=d)) == want


@pytest.mark.parametrize("which", [0, 1, 2, 3, 5])
def test_rwkv6_plan_takes_unaligned_float32_by_step(which):
    args = _rwkv(5, torch.float32)
    assert scan.rwkv6_plan(*args) == "chunked"
    args[which] = _offset(args[which])
    assert scan.rwkv6_plan(*args) == "step"


@pytest.mark.parametrize("t,which,want", [
    (9, 0, "step"), (9, 2, "step"), (9, 3, "step"), (9, 4, "step"),
    (9, 5, "step"), (9, 1, "chunk"), (1, 0, "decode"), (1, 2, "step")])
def test_mamba_plan_takes_unaligned_float32_by_step(t, which, want):
    """float32: the chunk route reads u, B, C, A and the state as 16-byte
    vectors (delta element by element); decode B, C, A and the state."""
    args = _mamba(t, torch.float32)
    args[which] = _offset(args[which])
    assert scan.mamba_plan(*args) == want


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_cpu_tensors_count_no_route(kind):
    """A CPU tensor takes the plain loop whatever its plan says: no
    forward launch counted, by any route."""
    fn, plain, wrapper, args = (
        (ops.rwkv6_scan, ref.rwkv6_scan, scan.rwkv6_scan,
         _rwkv(17, torch.bfloat16)) if kind == "rwkv" else
        (ops.mamba_scan, ref.mamba_scan, scan.mamba_scan,
         _mamba(17, torch.bfloat16)))
    before = dict(wrapper.route_launches), wrapper.launches
    for got, want in zip(fn(*args), plain(*args)):
        assert torch.equal(got, want)
    assert (dict(wrapper.route_launches), wrapper.launches) == before
    assert set(wrapper.route_launches) == set(
        scan.RWKV6_ROUTES if kind == "rwkv" else scan.MAMBA_ROUTES)
