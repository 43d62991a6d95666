"""paged_attention — decode attention over a paged KV cache (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_paged_attention`` of the JAX package's
``kernels/paged_attention.py``.  The CUDA source is
``csrc/paged_attention.cu``: a first pass gives each (sequence, head,
split of :data:`TOKENS_PER_SPLIT` tokens) one warp, which reads its own
page ids (the TPU's scalar prefetch), loads nothing for a ``-1`` page or
a slot past ``seq_len`` and keeps the online-softmax state in f32; a
second pass folds the splits together.  Reading each live slot's key and
value rows once bounds it.

``interpret`` was the Pallas mode and is not taken here.
"""
from __future__ import annotations

import torch

from . import ref
from .build import check, load
from .dispatch import check_float, on_cuda, refuse_grad, stream_of, suffix

#: head widths the kernel is built for
HEAD_DIMS = (64, 128)
#: tokens of one sequence that one warp of the first pass reads
TOKENS_PER_SPLIT = 256


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention of q (B, H, d) over the pages of each sequence.

    ``k_pages`` / ``v_pages`` are (P, page, H, d) in q's dtype (float32
    or bfloat16), ``d`` in :data:`HEAD_DIMS`; ``page_table`` (B, n_max)
    and ``seq_lens`` (B,) are int32.  Slots at or past ``seq_len`` and
    pages ``-1`` are poisoned and left out; a page id of at least P clips
    to ``P - 1``; a row with no live slot is **zeros**.  On CUDA tensors
    the kernel launches (and ``paged_attention.launches`` counts it); on
    CPU tensors the plain version in :mod:`repro_torch.kernels.ref` runs.
    """
    cuda = on_cuda(q, k_pages, v_pages, page_table, seq_lens)
    check_float("paged_attention", q, k_pages, v_pages)
    refuse_grad("paged_attention", q, k_pages, v_pages)
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q must be (B, H, d) and k_pages, v_pages alike "
                         f"(P, page, H, d), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, h, d = q.shape
    n_pages, page = k_pages.shape[:2]
    if k_pages.shape[2:] != (h, d):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} in H or d")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if n_pages == 0 or page == 0:
        raise ValueError("the page pool is empty")
    for name, t, shape in (("page_table", page_table, 2),
                           ("seq_lens", seq_lens, 1)):
        if t.dtype != torch.int32 or t.dim() != shape:
            raise TypeError(f"{name} must be a {shape}-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_max = page_table.shape[1]
    if page_table.shape[0] != b or seq_lens.shape[0] != b or n_max == 0:
        raise ValueError(f"page_table {tuple(page_table.shape)} and seq_lens "
                         f"{tuple(seq_lens.shape)} must be (B, n_max>0) and "
                         f"(B,) with B = {b}")
    if not cuda:
        return ref.paged_attention(q, k_pages, v_pages, page_table, seq_lens)
    out = torch.empty_like(q)
    if out.numel():
        pps = max(1, TOKENS_PER_SPLIT // page)
        n_split = -(-n_max // pps)
        # per (b, h, split): m and l, then the d-wide partial output
        scratch = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                              device=q.device)
        fn = getattr(load("paged_attention"),
                     f"paged_attention_{suffix(q.dtype)}")
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     page_table.data_ptr(), seq_lens.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(), b, h, d, n_pages,
                     page, n_max, pps, stream_of(q))
        check(err, "paged_attention")
        paged_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
paged_attention.launches = 0
