"""chunked_attention — online-softmax attention over key tiles (CUDA,
sm_90a), forward and backward.

The reference runs it as ``jax.lax.scan`` over key chunks of 512 in the
JAX package's ``models/layers.py`` (``chunked_attention``), which XLA
compiles into one loop on the device; no Pallas kernel computes it.  Its
model stack calls it on every attention without a KV cache: training,
the enc-dec encoder, every cross-attention sublayer (in prefill and in
each decode step).  Here it is a pair of hand-written kernels behind a
``torch.autograd.Function`` (``csrc/chunked_attention.cu``): the forward
keeps the running max, sum and output of a 64-row query tile in float32
registers and writes the output and the per-row log-sum-exp, never a
score; the backward recomputes the probabilities from that statistic
(``D = rowsum(dO * O)``, then a block per key tile for dK and dV and a
block per query tile for dQ, no atomics).  bfloat16 runs its products on
the tensor cores (``mma.sync`` m16n8k16, float32 accumulators), float32
on the CUDA cores.

The result does not depend on the reference's chunk of 512: a masked key
adds exactly zero to a row that has a live key, and every row has one
(Tk >= 1, ``q_offset >= 0``).  The kernels round otherwise than the loop
(scores unrounded, p and dS rounded to bfloat16 for their products), so
bfloat16 results are held to the loop run in float32 on the same values:
no further from it than the bfloat16 loop is, plus one bfloat16 ulp.

CUDA tensors launch the kernels (or raise); CPU tensors run the plain
loop :func:`repro_torch.kernels.ref.chunked_attention`, and autograd
differentiates it.  The kernel's plain backward is
:func:`repro_torch.kernels.ref.chunked_attention_bwd`.
``chunked_attention.launches`` counts forward launches,
``chunked_attention.bwd_launches`` backward ones (one entry: three
kernels).
"""
from __future__ import annotations

import torch

from . import ref
from .build import check, load
from .dispatch import FLOAT_DTYPES, aligned16, on_cuda, stream_of, suffix

#: head widths the kernels are built for
HEAD_DIMS = (16, 64, 128)


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      chunk: int = 512) -> torch.Tensor:
    """``softmax(q kᵀ / √d, masked) v`` over (B, H, T, d) inputs with equal
    head counts, float32 or bfloat16, Tk >= 1: the causal key j counts
    for query i iff ``j <= q_offset + i``.  Returns (B, H, Tq, d) in q's
    dtype.  On CPU tensors, the plain loop over chunks of ``chunk`` keys;
    on CUDA tensors (d in :data:`HEAD_DIMS`) the kernels, forward and
    backward, whose tiles do not depend on ``chunk``."""
    cuda = on_cuda(q, k, v)
    _check(q, k, v, q_offset, chunk)
    if not cuda:
        return ref.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"chunked_attention: head dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    return _ChunkedAttention.apply(q, k, v, bool(causal), int(q_offset))


def chunked_attention_fwd(q, k, v, causal: bool, q_offset: int = 0):
    """One launch of the forward kernel on checked CUDA tensors:
    ``(out, lse)``, lse the per-row log-sum-exp (B, H, Tq) float32."""
    q, k, v = (_operand(t) for t in (q, k, v))
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = getattr(load("chunked_attention"),
                 f"chunked_attention_fwd_{suffix(q.dtype)}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b * h, tq, k.shape[2], d, int(causal),
                 q_offset, stream_of(q))
    check(err, "chunked_attention forward")
    chunked_attention.launches += 1
    return out, lse


def chunked_attention_bwd(q, k, v, out, dout, lse, causal: bool,
                          q_offset: int = 0):
    """One launch of the backward entry on checked CUDA tensors (three
    kernels: D, then dK and dV, then dQ): ``(dq, dk, dv)``.  Its
    workspace is D, B * H * Tq float32."""
    q, k, v, out = (_operand(t) for t in (q, k, v, out))
    dout = _operand(dout.to(out.dtype))
    b, h, tq, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = getattr(load("chunked_attention"),
                 f"chunked_attention_bwd_{suffix(q.dtype)}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, tq,
                 k.shape[2], d, int(causal), q_offset, stream_of(q))
    check(err, "chunked_attention backward")
    chunked_attention.bwd_launches += 1
    return dq, dk, dv


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
#: to 0
chunked_attention.launches = 0
chunked_attention.bwd_launches = 0
