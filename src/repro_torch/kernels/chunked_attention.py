"""chunked_attention — online-softmax attention over key tiles (CUDA,
sm_90a), forward and backward.

The reference runs it as ``jax.lax.scan`` over key chunks of 512 in the
JAX package's ``models/layers.py`` (``chunked_attention``), which XLA
compiles into one loop on the device; no Pallas kernel computes it.  Its
model stack calls it on every attention without a KV cache: training,
the enc-dec encoder, every cross-attention sublayer (in prefill and in
each decode step).  Here it is hand-written kernels behind a
``torch.autograd.Function``: the forward writes the output and the
per-row log-sum-exp, never a score; the backward recomputes the
probabilities from that statistic (``D = rowsum(dO * O)``, then dK and
dV by key tile and dQ by query tile, no atomics, so two runs are bitwise
equal).

Routes, picked by :func:`attn_plan` and :func:`attn_bwd_plan` from the
dtype, the shapes and the alignment alone:

* ``"head"`` — float32 or bfloat16 at d :data:`HEAD_D` with at most
  :data:`HEAD_MAX_T` queries and keys (one query included), the tensors
  16-byte aligned and the backward's shared memory
  (:func:`head_smem_bytes`) within :data:`HEAD_SMEM_LIMIT`: every
  attention of the smoke configs (float32) and of Jamba's smoke config in
  bfloat16.  ``csrc/chunked_attention_head.cu``, one block a head and one
  launch a way: the head's operands in shared memory by bulk copies on one
  mbarrier, the forward's softmax whole, the backward's D, dK, dV and dQ
  in the same block; bfloat16 on ``mma.sync``, float32 in exact float32
  FMAs.  It takes precedence over every other route, forward and
  backward.
* ``"tile"`` — bfloat16, d in :data:`TILE_HEAD_DIMS`, more than
  :data:`SPLIT_MAX_TQ` queries: ``csrc/chunked_attention_sm90.cu``, a
  TMA ring and ``wgmma`` (the next tile's ``Q Kᵀ`` and the last tile's
  ``P V`` in flight beside the softmax, the two consumer warpgroups
  taking turns).  Backward ``"tile"`` for bfloat16 at those widths,
  whatever the forward's route: ``csrc/chunked_attention_bwd_sm90.cu``,
  dK / dV and dQ on TMA rings and ``wgmma``.  Widths 112 and 160 lie in
  shared memory as whole chunks of 64 columns, the padding zero-filled by
  the loads; the products run at the true width and nothing is stored
  past column d.
* ``"split"`` — bfloat16, at most :data:`SPLIT_MAX_TQ` queries (every
  decode step's cross attention has one): the same file; each head's
  keys cut into splits (:func:`split_plan`), float32 partials in a
  workspace, combined in split order by a second kernel.
* ``"mma"`` — bfloat16 at d 16 past the head route's limits, and
  bfloat16 tensors that are not 16-byte aligned (the entry copies such
  views, so only a direct call of a plan sees them):
  ``csrc/chunked_attention.cu`` on ``mma.sync``, forward and backward,
  built for every width of :data:`HEAD_DIMS`.
* ``"simt"`` — float32 past the head route's limits (every width but
  16): the same file's CUDA-core bodies.

The result does not depend on the reference's chunk of 512: a masked key
adds exactly zero to a row that has a live key, and every row has one
(Tk >= 1, ``q_offset >= 0``).  The kernels round otherwise than the loop
(scores unrounded, p and dS rounded to bfloat16 for their products; the
split route keeps p in float32), so bfloat16 results are held to the
loop run in float32 on the same values: no further from it than the
bfloat16 loop is, plus one bfloat16 ulp.

CUDA tensors launch the kernels of their route (or raise: a route that
fails never gives way to another or to the loop); CPU tensors run the
plain loop :func:`repro_torch.kernels.ref.chunked_attention`, and
autograd differentiates it.  Plain versions of the kernels' algorithms:
:func:`repro_torch.kernels.ref.chunked_attention_bwd` (every backward
route), :func:`repro_torch.kernels.ref.chunked_attention_split` (the
split route's partials and combine).  ``chunked_attention.launches``
counts forward launches (by route in ``.route_launches``),
``chunked_attention.bwd_launches`` backward ones (by route in
``.bwd_route_launches``; one entry: one kernel on the ``head`` route,
three on ``mma`` and ``simt``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from .build import check, load
from .dispatch import FLOAT_DTYPES, aligned16, on_cuda, stream_of, suffix

#: head widths the kernels are built for: every head width of the repo's
#: configs (Kimi-K2 112, StableLM-12B 160)
HEAD_DIMS = (16, 64, 112, 128, 160)
#: head widths of the ``tile`` routes (TMA boxes of 64 columns, 112 and
#: 160 padded to whole boxes; wgmma N at the true width)
TILE_HEAD_DIMS = (64, 112, 128, 160)
#: a bfloat16 call with at most this many queries takes the ``split``
#: route: every decode step's cross attention.  chip_smoke.py's ``[attn]``
#: threshold lines measure it on an H100 at Whisper's cross-attention
#: shape (128 heads x 1500 keys, d 64) and Llama-3.2-Vision's (512 heads x
#: 1024 keys, d 128): from two queries on the tile route won at both; at
#: one query the split route won at Llama-3.2-Vision's and the tile route
#: (one block a head) at Whisper's, by under a tenth (PERF.md)
SPLIT_MAX_TQ = 1
#: blocks the split route aims for (two a streaming multiprocessor of an
#: H100: more, shorter splits were slower at both decode shapes), and the
#: fewest keys a split
SPLIT_TARGET_BLOCKS = 2 * 132
SPLIT_MIN_KEYS = 64
#: the backward tile route pads its row statistics to this many rows
STAT_ROWS = 64
#: the ``head`` route's head width and its most queries and keys (the
#: kernel's ``kD`` and ``kMaxT``: every attention shape of the smoke
#: configs and of Jamba's bf16 smoke config is within them)
HEAD_D = 16
HEAD_MAX_T = 64
#: the shared memory a block takes without an opt-in, which a launch
#: inside a graph capture could not make
HEAD_SMEM_LIMIT = 48 * 1024
ROUTES = ("head", "tile", "split", "mma", "simt")
BWD_ROUTES = ("head", "tile", "mma", "simt")


def _check(q, k, v, q_offset: int, chunk: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"chunked_attention: q, k, v must be (B, H, T, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if (k.shape != v.shape or tuple(k.shape[:2]) != (b, h)
            or k.shape[3] != d):
        raise ValueError(f"chunked_attention: k and v must be (B, H, Tk, d) "
                         f"with q's B, H and d (expand GQA heads first), got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if q.dtype not in FLOAT_DTYPES:
        raise TypeError(f"chunked_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunked_attention: mixed dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.shape[2] < 1:
        raise ValueError("chunked_attention: Tk must be at least 1")
    if q_offset < 0:
        raise ValueError(f"chunked_attention: q_offset {q_offset} < 0")
    if chunk < 1:
        raise ValueError(f"chunked_attention: chunk {chunk} < 1")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: contiguous rows from a 16-byte
    boundary (a copy where the view is not)."""
    t = t.contiguous()
    return t if aligned16(t) else t.clone()


def head_smem_bytes(tq: int, tk: int, d: int, dtype: torch.dtype) -> int:
    """Shared memory of a ``head`` backward block (the forward's is
    less), as ``csrc/chunked_attention_head.cu``'s ``layout`` lays it
    out: a 16-byte mbarrier slot; q, o and dO of ``tq`` rows and k and v
    of ``tk`` rows of ``d`` elements, each rounded up to whole 16-row
    tiles (rq, rk rows); lse and D of every row in float32; for float32
    also dS, ``tq x (rk + 1)`` float32."""
    bf16 = dtype == torch.bfloat16
    rq, rk = -(-tq // 16) * 16, -(-tk // 16) * 16
    n = 16 + (3 * rq + 2 * rk) * d * (2 if bf16 else 4) + 2 * rq * 4
    return n if bf16 else n + tq * (rk + 1) * 4


def _head_fits(tensors, q, k) -> bool:
    """True when the ``head`` route takes a call on ``tensors`` (q, k and
    v, and for the backward out and dO): d :data:`HEAD_D`, at most
    :data:`HEAD_MAX_T` queries and keys, its shared memory within
    :data:`HEAD_SMEM_LIMIT`, every tensor 16-byte aligned (its bulk
    copies address each head's rows from there)."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    return (d == HEAD_D and tq <= HEAD_MAX_T and tk <= HEAD_MAX_T
            and head_smem_bytes(tq, tk, d, q.dtype) <= HEAD_SMEM_LIMIT
            and all(aligned16(t) for t in tensors))


def attn_plan(q, k, v, causal: bool, q_offset: int = 0) -> str:
    """The forward route of a checked call (see the module's docstring):
    ``"head"`` where it fits (:func:`_head_fits`), else ``"simt"`` for
    float32; for bfloat16 with q, k and v 16-byte aligned (the operands
    the entry passes always are), ``"split"`` up to :data:`SPLIT_MAX_TQ`
    queries, ``"tile"`` beyond that at d in :data:`TILE_HEAD_DIMS`, else
    ``"mma"``.  The mask (``causal``, ``q_offset``) does not change the
    route."""
    if _head_fits((q, k, v), q, k):
        return "head"
    if q.dtype != torch.bfloat16:
        return "simt"
    aligned = all(aligned16(t) for t in (q, k, v))
    if aligned and q.shape[2] <= SPLIT_MAX_TQ:
        return "split"
    if aligned and q.shape[3] in TILE_HEAD_DIMS:
        return "tile"
    return "mma"


def attn_bwd_plan(q, k, v, out, dout, causal: bool, q_offset: int = 0) -> str:
    """The backward route of a checked call, whatever route ran the
    forward: ``"head"`` where it fits (:func:`_head_fits` of the five
    tensors), else ``"tile"`` for bfloat16 at d in :data:`TILE_HEAD_DIMS`
    with the five tensors 16-byte aligned (TMA addresses them), ``"mma"``
    for other bfloat16 calls, ``"simt"`` for float32."""
    if _head_fits((q, k, v, out, dout), q, k):
        return "head"
    if q.dtype != torch.bfloat16:
        return "simt"
    if q.shape[3] in TILE_HEAD_DIMS and all(
            aligned16(t) for t in (q, k, v, out, dout)):
        return "tile"
    return "mma"


def split_plan(bh: int, tq: int, tk: int) -> Tuple[int, int]:
    """``(n_splits, split_keys)`` of a split-route call over ``bh`` heads:
    enough splits of at least :data:`SPLIT_MIN_KEYS` keys for about
    :data:`SPLIT_TARGET_BLOCKS` blocks, ``split_keys`` a multiple of 16
    and every split non-empty.  Its workspace is ``bh * tq * n_splits *
    (d + 2)`` float32."""
    rows = bh * tq  # a block per (row, split)
    n = max(1, min(-(-SPLIT_TARGET_BLOCKS // rows), -(-tk // SPLIT_MIN_KEYS)))
    keys = -(-tk // n)
    keys = -(-keys // 16) * 16
    return -(-tk // keys), keys


def _outputs(q):
    b, h, tq, _ = q.shape
    return (torch.empty_like(q),
            torch.empty((b, h, tq), dtype=torch.float32, device=q.device))


def _count(route: str) -> None:
    chunked_attention.launches += 1
    chunked_attention.route_launches[route] += 1


def _fwd(lib: str, entry: str, route: str, q, k, v, causal: bool,
         q_offset: int):
    """One launch of C entry ``entry`` of ``csrc/<lib>.cu`` (q, k, v, out,
    lse; B*H, tq, tk, d, causal, q_offset; stream) on checked CUDA
    tensors, counted to ``route``: ``(out, lse)``."""
    q, k, v = (_operand(t) for t in (q, k, v))
    b, h, tq, d = q.shape
    out, lse = _outputs(q)
    fn = getattr(load(lib), entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b * h, tq, k.shape[2], d, int(causal),
                 q_offset, stream_of(q))
    check(err, f"chunked_attention {route} forward")
    _count(route)
    return out, lse


def head_fwd(q, k, v, causal: bool, q_offset: int = 0):
    """One launch of the ``head`` forward on checked CUDA tensors (d
    :data:`HEAD_D`, at most :data:`HEAD_MAX_T` queries and keys; the
    kernel refuses other shapes, and this raises): ``(out, lse)``."""
    return _fwd("chunked_attention_head",
                f"chunked_attention_head_fwd_{suffix(q.dtype)}", "head", q,
                k, v, causal, q_offset)


def tile_fwd(q, k, v, causal: bool, q_offset: int = 0):
    """One launch of the ``tile`` forward on checked bfloat16 CUDA tensors
    (d in :data:`TILE_HEAD_DIMS`): ``(out, lse)``, lse the per-row
    log-sum-exp (B, H, Tq) float32."""
    return _fwd("chunked_attention_sm90", "chunked_attention_tile_fwd_bf16",
                "tile", q, k, v, causal, q_offset)


def split_fwd(q, k, v, causal: bool, q_offset: int = 0):
    """One launch of the ``split`` forward (the split kernel, then the
    combine) on checked bfloat16 CUDA tensors: ``(out, lse)``.  Its
    workspace is :func:`split_plan`'s."""
    q, k, v = (_operand(t) for t in (q, k, v))
    b, h, tq, d = q.shape
    n_splits, keys = split_plan(b * h, tq, k.shape[2])
    out, lse = _outputs(q)
    ws = torch.empty(b * h * tq * n_splits * (d + 2), dtype=torch.float32,
                     device=q.device)
    fn = load("chunked_attention_sm90").chunked_attention_split_fwd_bf16
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), ws.data_ptr(), b * h, tq, k.shape[2], d,
                 int(causal), q_offset, n_splits, keys, stream_of(q))
    check(err, "chunked_attention split forward")
    _count("split")
    return out, lse


def mma_fwd(q, k, v, causal: bool, q_offset: int = 0):
    """One launch of ``csrc/chunked_attention.cu``'s forward on checked
    CUDA tensors: the ``mma`` route for bfloat16, ``simt`` for float32.
    ``(out, lse)``."""
    return _fwd("chunked_attention",
                f"chunked_attention_fwd_{suffix(q.dtype)}",
                "mma" if q.dtype == torch.bfloat16 else "simt", q, k, v,
                causal, q_offset)


_FWD = {"head": head_fwd, "tile": tile_fwd, "split": split_fwd,
        "mma": mma_fwd, "simt": mma_fwd}


def chunked_attention_fwd(q, k, v, causal: bool, q_offset: int = 0):
    """The forward by :func:`attn_plan`'s route on checked CUDA tensors:
    ``(out, lse)``, lse the per-row log-sum-exp (B, H, Tq) float32."""
    q, k, v = (_operand(t) for t in (q, k, v))
    return _FWD[attn_plan(q, k, v, causal, q_offset)](q, k, v, causal,
                                                     q_offset)


def _bwd_operands(q, k, v, out, dout):
    q, k, v, out = (_operand(t) for t in (q, k, v, out))
    return q, k, v, out, _operand(dout.to(out.dtype))


def _count_bwd(route: str) -> None:
    chunked_attention.bwd_launches += 1
    chunked_attention.bwd_route_launches[route] += 1


def head_bwd(q, k, v, out, dout, lse, causal: bool, q_offset: int = 0):
    """One launch of the ``head`` backward on checked CUDA tensors (D,
    dK, dV and dQ in one kernel, no workspace; the shapes of
    :func:`head_fwd`): ``(dq, dk, dv)``."""
    q, k, v, out, dout = _bwd_operands(q, k, v, out, dout)
    b, h, tq, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = lse.float().contiguous()
    fn = getattr(load("chunked_attention_head"),
                 f"chunked_attention_head_bwd_{suffix(q.dtype)}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b * h, tq, k.shape[2], d,
                 int(causal), q_offset, stream_of(q))
    check(err, "chunked_attention head backward")
    _count_bwd("head")
    return dq, dk, dv


def tile_bwd(q, k, v, out, dout, lse, causal: bool, q_offset: int = 0):
    """One launch of the ``tile`` backward on checked bfloat16 CUDA
    tensors (d in :data:`TILE_HEAD_DIMS`; the row statistics, then dK and
    dV, then dQ): ``(dq, dk, dv)``.  Its workspace is lse · log2(e) and D
    for the rows padded to :data:`STAT_ROWS`, 2 * B * H * Tq_pad float32."""
    q, k, v, out, dout = _bwd_operands(q, k, v, out, dout)
    b, h, tq, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    pad = -(-tq // STAT_ROWS) * STAT_ROWS
    stats = torch.empty(2 * b * h * pad, dtype=torch.float32,
                        device=q.device)
    lse = lse.float().contiguous()
    fn = load("chunked_attention_bwd_sm90").chunked_attention_tile_bwd_bf16
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, tq,
                 k.shape[2], d, int(causal), q_offset, stream_of(q))
    check(err, "chunked_attention tile backward")
    _count_bwd("tile")
    return dq, dk, dv


def mma_bwd(q, k, v, out, dout, lse, causal: bool, q_offset: int = 0):
    """One launch of ``csrc/chunked_attention.cu``'s backward entry on
    checked CUDA tensors (three kernels: D, then dK and dV, then dQ): the
    ``mma`` route for bfloat16, ``simt`` for float32.  ``(dq, dk, dv)``;
    its workspace is D, B * H * Tq float32."""
    q, k, v, out, dout = _bwd_operands(q, k, v, out, dout)
    b, h, tq, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lse = lse.float().contiguous()
    fn = getattr(load("chunked_attention"),
                 f"chunked_attention_bwd_{suffix(q.dtype)}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, tq,
                 k.shape[2], d, int(causal), q_offset, stream_of(q))
    check(err, "chunked_attention backward")
    _count_bwd("mma" if q.dtype == torch.bfloat16 else "simt")
    return dq, dk, dv


_BWD = {"head": head_bwd, "tile": tile_bwd, "mma": mma_bwd,
        "simt": mma_bwd}


def chunked_attention_bwd(q, k, v, out, dout, lse, causal: bool,
                          q_offset: int = 0):
    """The backward by :func:`attn_bwd_plan`'s route on checked CUDA
    tensors, from any forward route's ``out`` and ``lse``: ``(dq, dk,
    dv)``."""
    q, k, v, out, dout = _bwd_operands(q, k, v, out, dout)
    route = attn_bwd_plan(q, k, v, out, dout, causal, q_offset)
    return _BWD[route](q, k, v, out, dout, lse, causal, q_offset)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      chunk: int = 512) -> torch.Tensor:
    """``softmax(q kᵀ / √d, masked) v`` over (B, H, T, d) inputs with equal
    head counts, float32 or bfloat16, Tk >= 1: the causal key j counts
    for query i iff ``j <= q_offset + i``.  Returns (B, H, Tq, d) in q's
    dtype.  On CPU tensors, the plain loop over chunks of ``chunk`` keys;
    on CUDA tensors (d in :data:`HEAD_DIMS`) the kernels of the planned
    routes, forward and backward, whose tiles do not depend on
    ``chunk``."""
    cuda = on_cuda(q, k, v)
    _check(q, k, v, q_offset, chunk)
    if not cuda:
        return ref.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"chunked_attention: head dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    return _ChunkedAttention.apply(q, k, v, bool(causal), int(q_offset))


class _ChunkedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        q, k, v = (_operand(t) for t in (q, k, v))
        out, lse = chunked_attention_fwd(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        # unpacked once: a checkpoint unpacks only once
        q, k, v, out, lse = ctx.saved_tensors
        return (*chunked_attention_bwd(q, k, v, out, dout, lse, ctx.causal,
                                       ctx.q_offset), None, None)


#: forward and backward kernel launches since the counts were last set
#: to 0, in all and by route
chunked_attention.launches = 0
chunked_attention.bwd_launches = 0
chunked_attention.route_launches = dict.fromkeys(ROUTES, 0)
chunked_attention.bwd_route_launches = dict.fromkeys(BWD_ROUTES, 0)
