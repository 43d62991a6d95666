"""flash_attention — online-softmax attention (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_flash_attention`` of the JAX package's
``kernels/flash_attention.py``.  Two hand-written kernels, chosen by
:func:`plan` from the dtype and the alignment of the tensors:

* ``"tma"`` — bfloat16 with every tensor 16-byte aligned:
  ``csrc/flash_attention_sm90.cu``.  One block per (batch*head, 128-row
  query tile), query tiles heaviest first (:func:`tile_schedule`); a
  producer warp streams 128-row K and V tiles through a two-stage TMA
  ring (3-D tensor maps over (B*H, T, d), so rows past T read zeros);
  two consumer warpgroups run ``Q K^T`` and ``P V`` on the tensor cores
  (``wgmma``), the online softmax in registers, ``p`` rounded to
  bfloat16 as the A operand of the PV product.
* ``"tiled"`` — float32, or bfloat16 that TMA cannot address (a base not
  16-byte aligned): ``csrc/flash_attention.cu``, one block per 64-row
  query tile, 32-row key tiles, products on the CUDA cores in float32.

Both keep the same semantics: scores, softmax state and the output sums
in float32, ``p`` rounded to ``v``'s dtype before the PV product as in
the Pallas kernel, causal masks aligned bottom-right, key tiles past the
frontier skipped, a row with no live key zeros.  A CUDA tensor always
takes one of the two kernels; a failed build or launch raises.

``bq`` / ``bk`` / ``interpret`` were TPU tiling and Pallas mode and are
not taken here.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from . import ref
from .build import check, load
from .dispatch import (aligned16, check_float, on_cuda, refuse_grad,
                       stream_of, suffix)

#: head widths the kernels are built for
HEAD_DIMS = (64, 128)
#: query and key rows of one tile of the TMA kernel (its TMA boxes are
#: 64 columns, the 128-byte swizzle's width, by these rows)
BLOCK_Q = BLOCK_K = 128
ROUTES = ("tma", "tiled")


class Plan(NamedTuple):
    """Which kernel takes a call, and the tiles passed to it (0 on the
    tiled route, whose kernel fixes its own)."""

    route: str
    block_q: int
    block_k: int


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         out: torch.Tensor) -> Plan:
    """The route of a checked call: ``"tma"`` for bfloat16 with all four
    tensors 16-byte aligned, else ``"tiled"``."""
    if q.dtype == torch.bfloat16 and all(
            aligned16(t) for t in (q, k, v, out)):
        return Plan("tma", BLOCK_Q, BLOCK_K)
    return Plan("tiled", 0, 0)


def key_tiles(q0: int, tq: int, tk: int, causal: bool,
              block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> int:
    """Key tiles the TMA kernel visits for the query tile at row ``q0``:
    all of them, or those left of the last row's bottom-right frontier
    (the kernel's own arithmetic)."""
    n = -(-tk // block_k)
    if causal:
        last = min(q0 + block_q, tq) - 1 + tk - tq
        n = min(n, 0 if last < 0 else last // block_k + 1)
    return n


def tile_schedule(bh: int, tq: int, tk: int, causal: bool,
                  block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> List[Tuple[int, int, int]]:
    """The TMA kernel's blocks in launch order, ``(bh, query tile, key
    tiles visited)`` each: every head's last query tile first, then the
    one before, so the tiles with the most key tiles start first."""
    q_tiles = -(-tq // block_q)
    out = []
    for b in range(bh * q_tiles):
        qt = q_tiles - 1 - b // bh
        out.append((b % bh, qt, key_tiles(qt * block_q, tq, tk, causal,
                                          block_q, block_k)))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, H, tq, d) over k, v (B, H, tk, d).

    Scale ``1/sqrt(d)``, ``d`` in :data:`HEAD_DIMS`, one float dtype for
    all three (float32 or bfloat16), output in it; GQA expansion is the
    caller's.  Causal masks align **bottom-right**: row ``i`` sees
    columns ``j <= i + tk - tq``; a row with no live key (causal rows
    ``i < tq - tk``) is **zeros**.  On CUDA tensors a kernel launches —
    the route of :func:`plan` — and ``flash_attention.launches`` counts
    it (``flash_attention.route_launches`` by route); on CPU tensors the
    plain version in :mod:`repro_torch.kernels.ref` runs.
    """
    cuda = on_cuda(q, k, v)
    check_float("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, T, d) with k and v alike, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in B, H or d")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    tk = k.shape[2]
    if tk == 0:
        raise ValueError("k and v need at least one key")
    if not cuda:
        return ref.flash_attention(q, k, v, causal=causal)
    out = torch.empty_like(q)
    if out.numel():
        p = plan(q, k, v, out)
        with torch.cuda.device(q.device):
            if p.route == "tma":
                fn = load("flash_attention_sm90").flash_attention_sm90_bf16
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b * h, tq, tk, d, int(causal),
                         p.block_q, p.block_k, stream_of(q))
            else:
                fn = getattr(load("flash_attention"),
                             f"flash_attention_{suffix(q.dtype)}")
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b * h, tq, tk, d, int(causal),
                         stream_of(q))
        check(err, f"flash_attention ({p.route})")
        flash_attention.launches += 1
        flash_attention.route_launches[p.route] += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
#: the same launches by route (:data:`ROUTES`)
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
