"""flash_attention — online-softmax attention (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_flash_attention`` of the JAX package's
``kernels/flash_attention.py``.  The CUDA source is
``csrc/flash_attention.cu``: one block per (batch, head, 64-row query
tile) loops over 32-row key tiles with the running max, sum and output
rows in registers; scores, softmax state and products are float32 and
``p`` is rounded to ``v``'s dtype before the PV product, as in the Pallas
kernel.  Causal masks align bottom-right (``repro.kernels.ref``'s
choice), key tiles past the frontier are skipped, and a row with no live
key is zeros.  It runs its products on the CUDA cores, far above the
tensor-core bound that limits this function: a simple kernel first.

``bq`` / ``bk`` / ``interpret`` were TPU tiling and Pallas mode and are
not taken here.
"""
from __future__ import annotations

import torch

from . import ref
from .build import check, load
from .dispatch import check_float, on_cuda, stream_of, suffix

#: head widths the kernel is built for
HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, H, tq, d) over k, v (B, H, tk, d).

    Scale ``1/sqrt(d)``, ``d`` in :data:`HEAD_DIMS`, one float dtype for
    all three (float32 or bfloat16), output in it; GQA expansion is the
    caller's.  Causal masks align **bottom-right**: row ``i`` sees
    columns ``j <= i + tk - tq``; a row with no live key (causal rows
    ``i < tq - tk``) is **zeros**.  On CUDA tensors the kernel launches
    (and ``flash_attention.launches`` counts it); on CPU tensors the
    plain version in :mod:`repro_torch.kernels.ref` runs.
    """
    cuda = on_cuda(q, k, v)
    check_float("flash_attention", q, k, v)
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
        fn = getattr(load("flash_attention"),
                     f"flash_attention_{suffix(q.dtype)}")
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b * h, tq, tk, d, int(causal),
                     stream_of(q))
        check(err, "flash_attention")
        flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
