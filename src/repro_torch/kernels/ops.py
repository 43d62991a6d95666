"""ops — the public kernel API, the counterpart of ``repro.kernels.ops``.

The same five functions with the same signatures, and the three device
loops that the reference runs as ``lax.scan`` inside its models and
that take a gradient: the two SSM scans (``rwkv6_scan``,
``mamba_scan``) and ``chunked_attention``.  Each goes to
its kernel wrapper, which dispatches on where the tensors lie (see
:mod:`repro_torch.kernels.dispatch`): CUDA tensors launch the
hand-written kernel or raise, CPU tensors run the plain version in
:mod:`repro_torch.kernels.ref`.  There is no switch that forces one or
the other, unlike the reference's ``FORCE_PALLAS_INTERPRET``.
"""
from __future__ import annotations

import torch

from .chunked_attention import chunked_attention as _chunked
from .flash_attention import flash_attention as _flash
from .paged_attention import paged_attention as _paged
from .ragged_matmul import ragged_matmul as _ragged
from .scan import mamba_scan as _mamba
from .scan import rwkv6_scan as _rwkv6
from .spec_gather import spec_gather as _gather
from .spec_scatter import spec_scatter_add as _scatter


def spec_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``; poisoned (idx<0) rows are zeros."""
    return _gather(table, idx)


def spec_scatter_add(table: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``table[idx] += values`` in place, poisoned stores dropped."""
    return _scatter(table, idx, values)


def ragged_matmul(x: torch.Tensor, w: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """Grouped GEMM: row ``r`` of ``x`` times ``w[r // capacity]``."""
    return _ragged(x, w, capacity=capacity)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention, causal masks aligned bottom-right."""
    return _flash(q, k, v, causal=causal)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention of one token per sequence over a paged KV pool."""
    return _paged(q, k_pages, v_pages, page_table, seq_lens)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s: torch.Tensor):
    """The RWKV-6 recurrence over time: ``(last state, y)``."""
    return _rwkv6(r, k, v, w, u, s)


def mamba_scan(u: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, s: torch.Tensor):
    """The Mamba recurrence over time: ``(last state, y)``."""
    return _mamba(u, delta, bmat, cmat, a, s)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over key chunks, causal masks aligned
    top-left at ``q_offset``; takes a gradient."""
    return _chunked(q, k, v, causal=causal, q_offset=q_offset, chunk=chunk)
