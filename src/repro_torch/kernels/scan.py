"""rwkv6_scan, mamba_scan — the SSM recurrences over time (CUDA, sm_90a),
forward and backward.

The reference runs both as ``jax.lax.scan`` in the JAX package's
``models/ssm.py`` (``rwkv6_block``, ``mamba_block``), which XLA compiles
into one loop on the device; no Pallas kernel computes them.  Here each
is a pair of hand-written kernels behind a ``torch.autograd.Function``:
``csrc/rwkv6_scan.cu`` (a block per (batch, head), the hd x hd float32
state a column a thread) and ``csrc/mamba_scan.cu`` (a thread per (batch,
channel), the N float32 state values in registers).  Each backward gives
the gradients of all six inputs, the first state included, and takes the
last state's cotangent (decode chains carry the state).  Unlike the five
Pallas sites' entries, these take a gradient, as the reference's scan
does.

Each forward has more than one route, picked by :func:`rwkv6_plan` and
:func:`mamba_plan` from the dtype, T, the width and the tensors'
alignment; each route has an entry for float32 and one for bfloat16:

* RWKV-6 ``"chunked"`` — T >= :data:`CHUNKED_MIN_T`, aligned tensors:
  ``csrc/rwkv6_chunk_sm90.cu``, the recurrence in chunks of 16 tokens on
  the tensor cores (TF32 products of hi + lo operand pairs, about 2**-20
  of float32), the state carried in registers from chunk to chunk;
  ``"step"`` — T = 1 and unaligned tensors: the step-serial kernels of
  ``csrc/rwkv6_scan.cu`` (one for decode, one for T >= 2 whose read-out
  sums as ``ref.rwkv6_scan_step`` does), bitwise the loop's state.
* Mamba ``"decode"`` — T = 1: one step without staging, the step
  kernel's arithmetic, bitwise the loop's state; ``"chunk"`` — prefill
  with D a multiple of the 16-byte vector (8 in bfloat16, 4 in float32)
  and aligned tensors: ``ex2.approx`` exponentials, fused updates, Δ·u
  and the read-out's state in float32, 16-byte loads and stores of u and
  y; ``"step"`` — the rest: the step-serial kernel, bitwise the loop's
  state, its read-out summed as ``ref.mamba_scan_step`` sums it.  All in
  ``csrc/mamba_scan.cu``.

The ``chunked`` and ``chunk`` routes round otherwise than the loops (the
loops round as the reference's step does): in bfloat16 they are held to
the loop run in float32 on the same values, no further from it than the
bfloat16 loop is; in float32 to the float32 loop at its own tolerances
(``1e-5`` of the largest for y and the last state).

Each backward has two routes, picked by :func:`rwkv6_bwd_plan` and
:func:`mamba_bwd_plan`: the inputs the forward's ``chunked`` (``chunk``)
route takes go by a ``chunked`` (``chunk``) backward, parallel in T
(``csrc/rwkv6_chunk_bwd_sm90.cu``; ``mamba_scan_bwd_chunk_*`` in
``csrc/mamba_scan.cu``): one pass keeps the state entering and the
cotangent leaving every :data:`BWD_UNIT` tokens, then every (batch, head
or channel block, unit) recomputes its states and emits its gradients
(plain versions: ``ref.rwkv6_scan_bwd_chunked``,
``ref.mamba_scan_bwd_chunked``).  The rest (T = 1, unaligned tensors,
Mamba's ragged widths) go by the ``step`` pair, parallel in T too and
with the step forward's roundings (``csrc/rwkv6_scan.cu``,
``csrc/mamba_scan.cu``): the same two passes, the state entering and the
cotangent leaving every :data:`RWKV6_STEP_UNIT` (RWKV-6) or
:data:`MAMBA_STEP_UNIT` (Mamba) tokens, then each unit's states rebuilt
bit for bit as the loop's and walked back (plain versions:
``ref.rwkv6_scan_bwd_step``, ``ref.mamba_scan_bwd_step``).  Every sum of
every backward is reduced in a fixed order, so two runs give the same
gradients.  Every entry of each pair stays callable alone, for timing:
the step entries are the baseline the chunked routes are timed
against.

CUDA tensors launch the kernels (or raise); CPU tensors run the plain
loops of :mod:`repro_torch.kernels.ref`, and autograd differentiates
them.  ``<fn>.launches`` counts forward launches (by route in
``<fn>.route_launches``), ``<fn>.bwd_launches`` backward ones (by route
in ``<fn>.bwd_route_launches``).
"""
from __future__ import annotations

import torch

from . import ref
from .build import check, load
from .dispatch import aligned16, on_cuda, stream_of, suffix

#: RWKV-6 head widths the kernels are built for (both routes)
HEAD_DIMS = (16, 32, 64)
#: Mamba state widths the kernels are built for
STATE_DIMS = (16,)
#: the forward routes of each scan
RWKV6_ROUTES = ("chunked", "step")
MAMBA_ROUTES = ("decode", "chunk", "step")
#: the backward routes of each scan
RWKV6_BWD_ROUTES = ("chunked", "step")
MAMBA_BWD_ROUTES = ("chunk", "step")
#: the shortest T that the RWKV-6 chunked route takes
CHUNKED_MIN_T = 2
#: tokens between the states (and cotangents) that the chunked backward
#: routes keep: ``kUnit`` of ``csrc/rwkv6_chunk_bwd_sm90.cu`` and
#: ``kUnitM`` of ``csrc/mamba_scan.cu``
BWD_UNIT = 64
#: channels a block of the Mamba chunk backward and step pair sums over
#: (``kBlkCh``)
MAMBA_BWD_BLOCK = 256
#: tokens between the states (and cotangents) that the step pairs keep:
#: ``kStepUnit`` of ``csrc/rwkv6_scan.cu`` and ``kStepUnitM`` of
#: ``csrc/mamba_scan.cu``
RWKV6_STEP_UNIT = 32
MAMBA_STEP_UNIT = 32


def _check(name: str, acts, f32s, shapes) -> None:
    """One float dtype of float32 or bfloat16 for ``acts``, float32 for
    ``f32s``, every tensor contiguous and of its shape."""
    dtype = acts[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or "
                        f"bfloat16)")
    for t in acts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    for t in f32s:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the state and A must be float32, got "
                            f"{t.dtype}")
    for t, shape in zip(acts + f32s, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _grad(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An incoming gradient as the kernels take it: ``like``'s dtype,
    contiguous."""
    return g.to(like.dtype).contiguous()


def rwkv6_plan(r, k, v, w, u, s) -> str:
    """The forward route of a checked RWKV-6 call (float32 or bfloat16):
    ``"chunked"`` for T >= :data:`CHUNKED_MIN_T` with r, k, v, w and the
    state 16-byte aligned (the kernel loads 16-byte vectors), else
    ``"step"``."""
    if r.shape[1] >= CHUNKED_MIN_T and all(aligned16(t)
                                           for t in (r, k, v, w, s)):
        return "chunked"
    return "step"


def mamba_plan(u, delta, bmat, cmat, a, s) -> str:
    """The forward route of a checked Mamba call: ``"decode"`` at T = 1,
    ``"chunk"`` for prefill with D a multiple of the 16-byte vector (8 in
    bfloat16, 4 in float32), else ``"step"``; both new routes take B, C,
    A and the state as 16-byte vectors (and the chunk route u), so an
    unaligned one goes by ``"step"``."""
    vectors = [bmat, cmat, a, s]
    if u.shape[1] == 1:
        return "decode" if all(aligned16(t) for t in vectors) else "step"
    # D a multiple of the activations in a 16-byte vector (``kVecOf`` in
    # csrc/scan.cuh)
    if (u.shape[2] % (16 // u.dtype.itemsize) == 0
            and all(aligned16(t) for t in vectors + [u])):
        return "chunk"
    return "step"


def rwkv6_bwd_plan(r, k, v, w, u, s, ds, dy) -> str:
    """The backward route of a checked RWKV-6 call, given the cotangents
    of the last state (or None) and of y as the backward takes them:
    ``"chunked"`` where the forward's plan is ``"chunked"`` and dy and ds
    are 16-byte aligned too (the kernels load 16-byte vectors of every
    activation and of both states), else ``"step"``."""
    if (rwkv6_plan(r, k, v, w, u, s) == "chunked" and aligned16(dy)
            and (ds is None or aligned16(ds))):
        return "chunked"
    return "step"


def mamba_bwd_plan(u, delta, bmat, cmat, a, s, ds, dy) -> str:
    """The backward route of a checked Mamba call, given the cotangents
    as the backward takes them: ``"chunk"`` where the forward's plan is
    ``"chunk"`` (prefill, D a multiple of the 16-byte vector, aligned) and
    dy is 16-byte aligned too, else ``"step"``."""
    if mamba_plan(u, delta, bmat, cmat, a, s) == "chunk" and aligned16(dy):
        return "chunk"
    return "step"


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s: torch.Tensor):
    """The RWKV-6 recurrence: ``S_t = diag(w_t) S_{t-1} + k_tᵀ v_t``,
    ``y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)``.

    r, k, v, w: (B, T, H, hd) in float32 or bfloat16, T >= 1; u (H, hd)
    in their dtype; s (B, H, hd, hd) float32.  Returns the last state
    (float32) and y (B, T, H, hd) in r's dtype, rounded as
    :func:`repro_torch.kernels.ref.rwkv6_scan` rounds, except on the
    chunked route (:func:`rwkv6_plan`), whose split TF32 products stand
    closer to the float32 loop than the bfloat16 loop does.  On CUDA
    tensors (hd in :data:`HEAD_DIMS`) the kernels launch, forward and
    backward.
    """
    cuda = on_cuda(r, k, v, w, u, s)
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be (B, T, H, hd), got "
                         f"{tuple(r.shape)}")
    b, t, h, hd = r.shape
    _check("rwkv6_scan", [r, k, v, w, u], [s],
           [(b, t, h, hd)] * 4 + [(h, hd), (b, h, hd, hd)])
    if t < 1:
        raise ValueError("rwkv6_scan: T must be at least 1")
    if not cuda:
        return ref.rwkv6_scan(r, k, v, w, u, s)
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {hd} not in {HEAD_DIMS}")
    return _RWKV6Scan.apply(r, k, v, w, u, s)


def rwkv6_scan_fwd(r, k, v, w, u, s0):
    """One launch of the step route's forward kernel on checked CUDA
    tensors (either dtype, any T): ``(last state, y)``."""
    return _rwkv6_launch("step", "rwkv6_scan",
                         f"rwkv6_scan_fwd_{suffix(r.dtype)}", r, k, v, w, u,
                         s0)


def rwkv6_chunked_fwd(r, k, v, w, u, s0):
    """One launch of the chunked route's kernel on checked CUDA tensors
    (either dtype), 16-byte aligned: ``(last state, y)``."""
    return _rwkv6_launch("chunked", "rwkv6_chunk_sm90",
                         f"rwkv6_scan_chunked_{suffix(r.dtype)}", r, k, v, w,
                         u, s0)


def _rwkv6_launch(route, lib, entry, r, k, v, w, u, s0):
    b, t, h, hd = r.shape
    y = torch.empty_like(r)
    s = torch.empty_like(s0)
    fn = getattr(load(lib), entry)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), s.data_ptr(),
                 b, t, h, hd, stream_of(r))
    check(err, f"rwkv6_scan forward ({route})")
    rwkv6_scan.launches += 1
    rwkv6_scan.route_launches[route] += 1
    return s, y


#: each route's one launch
_RWKV6_FWD = {"chunked": rwkv6_chunked_fwd, "step": rwkv6_scan_fwd}


def rwkv6_scan_bwd(r, k, v, w, u, s0, ds, dy):
    """The backward on checked CUDA tensors by the route
    :func:`rwkv6_bwd_plan` picks, given the cotangents of the last state
    (or None) and of y: the gradients of r, k, v, w, u and s0."""
    dy = _grad(dy, r)
    ds = None if ds is None else _grad(ds, s0)
    route = rwkv6_bwd_plan(r, k, v, w, u, s0, ds, dy)
    return _RWKV6_BWD[route](r, k, v, w, u, s0, ds, dy)


def rwkv6_step_bwd(r, k, v, w, u, s0, ds, dy):
    """One launch of the step pair's backward entry (either dtype, any T
    and alignment): the state entering and the cotangent leaving every
    :data:`RWKV6_STEP_UNIT` tokens, float32, and du's partial sums are its
    workspace: (2 * B * H * hd * hd + B * H * hd) * ceil(T / 32) * 4
    bytes."""
    return _rwkv6_bwd_launch("step", "rwkv6_scan",
                             f"rwkv6_scan_bwd_{suffix(r.dtype)}",
                             RWKV6_STEP_UNIT, r, k, v, w, u, s0, ds, dy)


def rwkv6_chunked_bwd(r, k, v, w, u, s0, ds, dy):
    """One launch of the chunked route's backward entry
    (``csrc/rwkv6_chunk_bwd_sm90.cu``) on checked CUDA tensors (either
    dtype), 16-byte aligned: the state entering and the cotangent leaving
    every :data:`BWD_UNIT` tokens, float32, and du's partial sums are its
    workspace: (2 * B * H * hd * hd + B * H * hd) * ceil(T / 64) * 4
    bytes."""
    return _rwkv6_bwd_launch("chunked", "rwkv6_chunk_bwd_sm90",
                             f"rwkv6_scan_bwd_chunked_{suffix(r.dtype)}",
                             BWD_UNIT, r, k, v, w, u, s0, ds, dy)


def _rwkv6_bwd_launch(route, lib, entry, unit, r, k, v, w, u, s0, ds, dy):
    b, t, h, hd = r.shape
    dy = _grad(dy, r)
    ds = None if ds is None else _grad(ds, s0)
    n_u = -(-t // unit)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    ds0 = torch.empty_like(s0)
    ws = torch.empty(n_u * b * h * hd * (2 * hd + 1), dtype=torch.float32,
                     device=r.device)
    fn = getattr(load(lib), entry)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), dy.data_ptr(), _ptr(ds),
                 ws.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 dw.data_ptr(), du.data_ptr(), ds0.data_ptr(), b, t, h, hd,
                 stream_of(r))
    check(err, f"rwkv6_scan backward ({route})")
    _count_bwd(rwkv6_scan, route)
    return dr, dk, dv, dw, du.to(u.dtype), ds0


#: each backward route's one launch
_RWKV6_BWD = {"chunked": rwkv6_chunked_bwd, "step": rwkv6_step_bwd}


def _count_bwd(fn, route: str) -> None:
    fn.bwd_launches += 1
    fn.bwd_route_launches[route] += 1


class _RWKV6Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        # an unused last state gives the backward no cotangent (None)
        ctx.set_materialize_grads(False)
        return _RWKV6_FWD[rwkv6_plan(r, k, v, w, u, s0)](r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, ds, dy):
        saved = ctx.saved_tensors  # once: a checkpoint unpacks only once
        dy = torch.zeros_like(saved[0]) if dy is None else dy
        return rwkv6_scan_bwd(*saved, ds, dy)


#: forward and backward kernel launches since the counts were last set
#: to 0, and the launches by route (:data:`RWKV6_ROUTES`,
#: :data:`RWKV6_BWD_ROUTES`)
rwkv6_scan.launches = 0
rwkv6_scan.bwd_launches = 0
rwkv6_scan.route_launches = dict.fromkeys(RWKV6_ROUTES, 0)
rwkv6_scan.bwd_route_launches = dict.fromkeys(RWKV6_BWD_ROUTES, 0)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def mamba_scan(u: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, s: torch.Tensor):
    """The Mamba recurrence: ``s_t = exp(Δ_t A) ⊙ s_{t-1} + Δ_t u_t B_t``,
    ``y_t = C_t s_t``.

    u: (B, T, D), delta (B, T, 1), bmat and cmat (B, T, N), all in
    float32 or bfloat16, T >= 1; a (D, N) and s (B, D, N) float32.
    Returns the last state (float32) and y (B, T, D) in cmat's dtype,
    rounded as :func:`repro_torch.kernels.ref.mamba_scan` rounds, except
    on the chunk route (:func:`mamba_plan`), which keeps Δ·u and the
    read-out's state in float32 and takes its exponentials from
    ``ex2.approx`` (in float32 within ``1e-5`` of the loop's largest).  On
    CUDA tensors (N in
    :data:`STATE_DIMS`) the kernels launch, forward and backward.
    """
    cuda = on_cuda(u, delta, bmat, cmat, a, s)
    if u.dim() != 3 or bmat.dim() != 3:
        raise ValueError(f"mamba_scan: u and bmat must be (B, T, D) and "
                         f"(B, T, N), got {tuple(u.shape)}, "
                         f"{tuple(bmat.shape)}")
    b, t, d = u.shape
    n = bmat.shape[2]
    _check("mamba_scan", [u, delta, bmat, cmat], [a, s],
           [(b, t, d), (b, t, 1), (b, t, n), (b, t, n), (d, n), (b, d, n)])
    if t < 1:
        raise ValueError("mamba_scan: T must be at least 1")
    if not cuda:
        return ref.mamba_scan(u, delta, bmat, cmat, a, s)
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim {n} not in {STATE_DIMS}")
    return _MambaScan.apply(u, delta, bmat, cmat, a, s)


def mamba_scan_fwd(u, delta, bmat, cmat, a, s0):
    """One launch of the step route's forward kernel on checked CUDA
    tensors (either dtype, any T): ``(last state, y)``."""
    return _mamba_launch("step", f"mamba_scan_fwd_{suffix(u.dtype)}", True,
                         u, delta, bmat, cmat, a, s0)


def mamba_decode_fwd(u, delta, bmat, cmat, a, s0):
    """One launch of the decode route's kernel on checked CUDA tensors at
    T = 1, B, C, A and the state 16-byte aligned: ``(last state, y)``."""
    if u.shape[1] != 1:
        raise ValueError(f"mamba_scan decode route: T = 1 only, got "
                         f"{u.shape[1]}")
    return _mamba_launch("decode", f"mamba_scan_decode_{suffix(u.dtype)}",
                         False, u, delta, bmat, cmat, a, s0)


def mamba_chunk_fwd(u, delta, bmat, cmat, a, s0):
    """One launch of the chunk route's kernel on checked CUDA tensors
    (either dtype), D a multiple of the 16-byte vector, 16-byte aligned:
    ``(last state, y)``."""
    return _mamba_launch("chunk", f"mamba_scan_chunk_{suffix(u.dtype)}", True,
                         u, delta, bmat, cmat, a, s0)


def _mamba_launch(route, entry, with_t, u, delta, bmat, cmat, a, s0):
    b, t, d = u.shape
    y = torch.empty_like(u)
    s = torch.empty_like(s0)
    fn = getattr(load("mamba_scan"), entry)
    dims = (b, t, d) if with_t else (b, d)
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), delta.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), a.data_ptr(), s0.data_ptr(), y.data_ptr(),
                 s.data_ptr(), *dims, bmat.shape[2], stream_of(u))
    check(err, f"mamba_scan forward ({route})")
    mamba_scan.launches += 1
    mamba_scan.route_launches[route] += 1
    return s, y


#: each route's one launch
_MAMBA_FWD = {"decode": mamba_decode_fwd, "chunk": mamba_chunk_fwd,
              "step": mamba_scan_fwd}


def mamba_scan_bwd(u, delta, bmat, cmat, a, s0, ds, dy):
    """The backward on checked CUDA tensors by the route
    :func:`mamba_bwd_plan` picks, given the cotangents of the last state
    (or None) and of y: the gradients of u, delta, bmat, cmat, a and
    s0."""
    dy = _grad(dy, u)
    ds = None if ds is None else _grad(ds, s0)
    route = mamba_bwd_plan(u, delta, bmat, cmat, a, s0, ds, dy)
    return _MAMBA_BWD[route](u, delta, bmat, cmat, a, s0, ds, dy)


def mamba_step_bwd(u, delta, bmat, cmat, a, s0, ds, dy):
    """One launch of the step pair's backward entry (either dtype, any T,
    width and alignment): its workspace is laid out as the chunk route's
    (see :func:`mamba_chunk_bwd`) with units of :data:`MAMBA_STEP_UNIT`
    steps, every sum reduced in a fixed order."""
    return _mamba_bwd_launch("step", f"mamba_scan_bwd_{suffix(u.dtype)}",
                             MAMBA_STEP_UNIT, u, delta, bmat, cmat, a, s0, ds,
                             dy)


def mamba_chunk_bwd(u, delta, bmat, cmat, a, s0, ds, dy):
    """One launch of the chunk route's backward entry
    (``mamba_scan_bwd_chunk_*`` in ``csrc/mamba_scan.cu``) on checked CUDA
    tensors (either dtype), D a multiple of the 16-byte vector, 16-byte
    aligned.  Its workspace, float32: the state entering and the
    cotangent leaving every :data:`BWD_UNIT` steps and da's partial sums
    over each unit (3 * B * ceil(T / 64) * D * N), and the partial sums of
    dB, dC and ddelta over each block of :data:`MAMBA_BWD_BLOCK` channels
    (ceil(D / 256) * B * T * (2N + 1)); every sum is reduced in a fixed
    order."""
    return _mamba_bwd_launch("chunk",
                             f"mamba_scan_bwd_chunk_{suffix(u.dtype)}",
                             BWD_UNIT, u, delta, bmat, cmat, a, s0, ds, dy)


def _mamba_bwd_launch(route, entry, unit, u, delta, bmat, cmat, a, s0, ds,
                      dy):
    b, t, d = u.shape
    n = bmat.shape[2]
    dy = _grad(dy, u)
    ds = None if ds is None else _grad(ds, s0)
    n_u = -(-t // unit)
    n_blk = -(-d // MAMBA_BWD_BLOCK)
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty_like(u)
    sums = torch.empty((b, t, 2 * n + 1), **f32)   # dB, dC, ddelta
    da = torch.empty((d, n), **f32)
    ds0 = torch.empty_like(s0)
    ws = torch.empty(3 * b * n_u * d * n + n_blk * b * t * (2 * n + 1), **f32)
    fn = getattr(load("mamba_scan"), entry)
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), delta.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), a.data_ptr(), s0.data_ptr(), dy.data_ptr(),
                 _ptr(ds), ws.data_ptr(), du.data_ptr(), sums.data_ptr(),
                 da.data_ptr(), ds0.data_ptr(), b, t, d, n, stream_of(u))
    check(err, f"mamba_scan backward ({route})")
    _count_bwd(mamba_scan, route)
    return (du, sums[..., 2 * n:].to(delta.dtype),
            sums[..., :n].to(bmat.dtype), sums[..., n:2 * n].to(cmat.dtype),
            da, ds0)


#: each backward route's one launch
_MAMBA_BWD = {"chunk": mamba_chunk_bwd, "step": mamba_step_bwd}


class _MambaScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, delta, bmat, cmat, a, s0):
        ctx.save_for_backward(u, delta, bmat, cmat, a, s0)
        # an unused last state gives the backward no cotangent (None)
        ctx.set_materialize_grads(False)
        return _MAMBA_FWD[mamba_plan(u, delta, bmat, cmat, a, s0)](
            u, delta, bmat, cmat, a, s0)

    @staticmethod
    def backward(ctx, ds, dy):
        saved = ctx.saved_tensors  # once: a checkpoint unpacks only once
        dy = torch.zeros_like(saved[0]) if dy is None else dy
        return mamba_scan_bwd(*saved, ds, dy)


#: forward and backward kernel launches since the counts were last set
#: to 0, and the launches by route (:data:`MAMBA_ROUTES`,
#: :data:`MAMBA_BWD_ROUTES`)
mamba_scan.launches = 0
mamba_scan.bwd_launches = 0
mamba_scan.route_launches = dict.fromkeys(MAMBA_ROUTES, 0)
mamba_scan.bwd_route_launches = dict.fromkeys(MAMBA_BWD_ROUTES, 0)
