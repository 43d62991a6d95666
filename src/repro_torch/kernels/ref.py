"""Plain PyTorch versions of the kernels (the semantic ground truth).

Semantics follow the reference oracle of the JAX package: a *negative
index* marks a mis-speculated request — a gather returns a zero row for
it, a scatter drops it, attention leaves it out of the softmax — and an
index of at least the row count clips to the last row.  Arithmetic
follows the Pallas kernels: float32 accumulation and softmax state, the
output in the input's dtype.  The kernel wrappers run these on CPU
tensors; on the card they are what the CUDA kernels are held against.
"""
from __future__ import annotations

import torch


def _safe(idx: torch.Tensor, rows: int) -> torch.Tensor:
    return idx.clamp(0, rows - 1).long()


def spec_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``; poisoned (idx<0) rows are zeros."""
    rows = table[_safe(idx, table.shape[0])]
    return torch.where((idx < 0)[:, None], torch.zeros_like(rows), rows)


def spec_scatter_add(table: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += values[i]`` in place, poisoned (idx<0) stores
    dropped; duplicate indices add up.  Returns ``table``."""
    vals = torch.where((idx < 0)[:, None], torch.zeros_like(values), values)
    return table.index_put_((_safe(idx, table.shape[0]),), vals,
                            accumulate=True)


def bf16_sum_bound(table: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Per-element bound on how far a bfloat16 scatter-add of ``values``
    into ``table`` at ``idx`` may lie from the float32 sum, in float32.

    Each add rounds its sum to bfloat16, a relative error of at most
    ``2**-8``; a destination that receives ``k`` live requests rounds
    ``k`` times, each time at most ``2**-8`` of ``|table| + sum |v|``.
    The bound is ``(k + 1) * 2**-8 * (|table| + sum |v|)``: one rounding
    more than the adds, for the float32 sum's own rounding.  A
    destination that receives one request from a zero table is exact.
    """
    live = (idx >= 0)[:, None]
    safe = _safe(idx, table.shape[0])
    mag = torch.where(live, values.float().abs(), torch.zeros(()))
    absum = table.float().abs().index_add(0, safe, mag)
    hits = torch.zeros(table.shape[0], dtype=torch.float32,
                       device=table.device).index_add(
        0, safe, live[:, 0].float())
    return (hits[:, None] + 1) * 2.0 ** -8 * absum


def ragged_matmul(x: torch.Tensor, w: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """Grouped GEMM: row ``r`` of ``x`` (E*capacity, D), expert-contiguous,
    times ``w[r // capacity]`` of ``w`` (E, D, F); float32 sums, the
    output (E*capacity, F) in ``x``'s dtype."""
    e, d, f = w.shape
    xg = x.reshape(e, capacity, d).float()
    return torch.matmul(xg, w.float()).reshape(e * capacity, f).to(x.dtype)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor,
                round_p: bool) -> torch.Tensor:
    """``softmax(s) @ v`` over the last axis of the float32 scores ``s``,
    where ``-inf`` marks a dead key; a row with no live key is zeros.
    The unnormalised ``p`` is rounded to ``v``'s dtype first when
    ``round_p``; the sum ``l`` is taken before that rounding."""
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if round_p:
        p = p.to(v.dtype)
    o = torch.matmul(p.float(), v.float())
    return torch.where(l > 0, o / l, torch.zeros_like(o))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, H, tq, d) over k, v (B, H, tk, d), scale
    ``1/sqrt(d)``; GQA expansion is the caller's.

    Causal masks align **bottom-right**, as ``repro.kernels.ref`` does:
    query row ``i`` sees key columns ``j <= i + tk - tq``.  (The Pallas
    kernel aligned top-left; the two agree only at ``tq == tk``.)  A row
    with no live key — causal rows ``i < tq - tk`` when ``tq > tk`` —
    returns **zeros**, not NaN.  Scores and softmax state are float32,
    ``p`` is rounded to ``v``'s dtype before the PV product, as the Pallas
    kernel does, and the output is in ``q``'s dtype.
    """
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    if causal:
        live = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~live, float("-inf"))
    return _softmax_pv(s, v, round_p=True).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention of one token per sequence over a paged KV cache.

    q (B, H, d); k_pages, v_pages (P, page, H, d); page_table (B, n_max)
    int32; seq_lens (B,) int32; returns (B, H, d) in q's dtype.  Slot
    ``s`` of sequence ``b`` is row ``s % page`` of page
    ``page_table[b, s // page]``; it is live when ``s < seq_lens[b]`` and
    the page id is not ``-1`` (poison: the speculatively fetched tail).
    A page id of at least P clips to ``P - 1``, as ``repro.kernels.ref``
    does.  A row with no live slot (seq_len 0, every page ``-1``) returns
    **zeros**, not NaN (the reference) nor the mean of V (the Pallas
    kernel).  Scores, softmax state and the PV product are float32.
    """
    b, h, d = q.shape
    n_max = page_table.shape[1]
    page = k_pages.shape[1]
    safe = page_table.clamp(0, k_pages.shape[0] - 1).long()
    k = k_pages[safe].permute(0, 3, 1, 2, 4).reshape(b, h, n_max * page, d)
    v = v_pages[safe].permute(0, 3, 1, 2, 4).reshape(b, h, n_max * page, d)
    pos = torch.arange(n_max * page, device=q.device)
    live = pos[None, :] < seq_lens[:, None].long()
    live &= ~(page_table < 0).repeat_interleave(page, dim=1)
    s = torch.matmul(q.float()[:, :, None, :],
                     k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    return _softmax_pv(s, v, round_p=False)[:, :, 0].to(q.dtype)
