"""Attention-free blocks: RWKV-6 (Finch, data-dependent decay) and a Mamba
selective-SSM block (for the Jamba hybrid).

The counterpart of the JAX package's ``models/ssm.py``.  The linear
recurrences, which the reference leaves to ``lax.scan``, are the scans
of :mod:`repro_torch.kernels.scan`: hand-written CUDA kernels, forward
and backward, on CUDA tensors, and Python loops over time, one step per
token, on CPU tensors.  Both round at every step where the reference, as
XLA runs it, rounds: the states are float32; RWKV's k·v is rounded to
the activations' dtype before it joins the state, Mamba's Δ·u·B is not.
Decode carries the state explicitly.

Under a mesh (DTensor parameters and states) the heads (RWKV) or the
channels (Mamba) shard over ``model``, as the states do, and each rank
scans its own (:func:`repro_torch.models.sharding.local_call`); the
small per-channel parameters that every shard needs whole (RWKV's
token-shift mix, Mamba's B and C projections and A) and RWKV's
token-shift carry are replicated over ``model`` first, and the output
projection's partial sums are reduced once.  On plain tensors these
steps do nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import scan
from .layers import weight, whole_product
from .sharding import constrain, local_call, reduce, unshard


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def rwkv6_block(params: Dict, x: torch.Tensor, *, n_heads: int,
                head_dim: int, state: Optional[Tuple] = None,
                return_state: bool = False):
    """RWKV-6 time-mix: S_t = diag(w_t)·S_{t-1} + k_tᵀ·v_t; y_t = r_t·S_t
    with data-dependent decay w_t (the Finch contribution).

    x: (B, T, D).  state: (S, x_last) with S (B, H, hd, hd) float32 and
    x_last (B, D) carrying the token shift across decode steps; the
    returned x_last is in x's dtype.
    """
    b, t, _ = x.shape
    h, hd = n_heads, head_dim

    # token shift (x_{t-1} mix)
    if state is not None:
        s_in, x_last = state
        x_last = unshard(x_last, ("model",))
        x_prev = torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    else:
        s_in = None
        x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    mix = unshard(params["mu"], ("model",))  # (4, D) for r, k, v, w
    # four distinct inputs of four tensor-parallel projections: each
    # input's gradient (a partial sum over ``model``) is reduced at its
    # projection, as the reference's partitioner and tensor-parallel
    # linears reduce it
    xr, xk, xv, xw = (constrain(x * mix[i] + x_prev * (1 - mix[i]),
                                "dp", None, None) for i in range(4))

    r = (xr @ weight(params["wr"])).view(b, t, h, hd)
    k = (xk @ weight(params["wk"])).view(b, t, h, hd)
    v = (xv @ weight(params["wv"])).view(b, t, h, hd)
    # data-dependent decay in (0, 1)
    w = torch.sigmoid((xw @ weight(params["ww"])).view(b, t, h, hd)
                      + params["w_bias"].view(1, 1, h, hd))
    u = params["u"].view(h, hd)  # bonus for the current token

    s0 = s_in if s_in is not None else torch.zeros(
        (b, h, hd, hd), dtype=torch.float32, device=x.device)
    s_fin, y = _rwkv6_scan(r, k, v, w, u, s0)
    y = reduce(y.reshape(b, t, h * hd) @ weight(params["wo"]),
               "dp", None, None)
    if return_state:
        return y, (s_fin, x[:, -1])
    return y


def _rwkv6_scan(r, k, v, w, u, s):
    """The recurrence over time (:func:`repro_torch.kernels.scan.
    rwkv6_scan`).  r, k, v, w: (B, T, H, hd); u: (H, hd); s: (B, H, hd,
    hd) float32.  Returns the last state and the outputs (B, T, H, hd) in
    r's dtype.  On DTensors each rank scans its own batch rows and heads
    (:func:`repro_torch.models.sharding.local_call`)."""
    return local_call(_contiguous(scan.rwkv6_scan), (r, k, v, w, u, s),
                      _RWKV6_DIMS)


#: where the batch (0) and the heads (2) of r lie in each input of the
#: RWKV-6 scan, then in its outputs (the state, y)
_RWKV6_DIMS = ([{0: 0, 2: 2}] * 4 + [{2: 0}, {0: 0, 2: 1}],
               [{0: 0, 2: 1}, {0: 0, 2: 2}])


# ---------------------------------------------------------------------------
# Mamba (selective SSM), simplified for the Jamba hybrid
# ---------------------------------------------------------------------------


def mamba_block(params: Dict, x: torch.Tensor, *, d_state: int,
                state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Selective SSM: h_t = exp(Δ_t·A)⊙h_{t-1} + Δ_t·B_t·u_t; y = C_t·h_t.

    x: (B, T, D); state: (B, D, N) float32.  ``a_log`` is float32 whatever
    the activations' dtype, so exp(Δ·A) and the state are float32.
    """
    b, t, d = x.shape
    n = d_state

    u = x @ weight(params["in_proj"])                          # (B, T, D)
    gate = F.silu(x @ weight(params["gate_proj"]))
    delta = F.softplus(x @ params["dt_proj"])[..., None]       # (B, T, 1)
    bmat = whole_product(x, params["b_proj"])                  # (B, T, N)
    cmat = whole_product(x, params["c_proj"])
    # (D, N) < 0, whole over ``model`` on a mesh (its shard of N is not a
    # shard of the channels)
    a = -torch.exp(unshard(weight(params["a_log"]), ("model",)))

    s0 = state if state is not None else torch.zeros(
        (b, d, n), dtype=torch.float32, device=x.device)
    s_fin, y = _mamba_scan(u, delta, bmat, cmat, a, s0)
    y = reduce((y * gate) @ weight(params["out_proj"]), "dp", None, None)
    if return_state:
        return y, s_fin
    return y


def _mamba_scan(u, delta, bmat, cmat, a, s):
    """The recurrence over time (:func:`repro_torch.kernels.scan.
    mamba_scan`).  u: (B, T, D); delta: (B, T, 1); bmat, cmat: (B, T, N);
    a: (D, N) float32; s: (B, D, N) float32.  Returns the last state and
    the outputs (B, T, D) in cmat's dtype.  On DTensors each rank scans
    its own batch rows and channels
    (:func:`repro_torch.models.sharding.local_call`)."""
    return local_call(_contiguous(scan.mamba_scan),
                      (u, delta, bmat, cmat, a, s), _MAMBA_DIMS)


#: where the batch (0) and the channels (2) of u lie in each input of the
#: Mamba scan, then in its outputs (the state, y)
_MAMBA_DIMS = ([{0: 0, 2: 2}, {0: 0}, {0: 0}, {0: 0}, {2: 0},
                {0: 0, 2: 1}], [{0: 0, 2: 1}, {0: 0, 2: 2}])


def _contiguous(fn):
    """``fn`` on contiguous copies of its arguments (the scans' layout)."""
    return lambda *args: fn(*(t.contiguous() for t in args))
