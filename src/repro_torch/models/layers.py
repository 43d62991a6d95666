"""Core layers: RMSNorm, RoPE, GQA attention, SwiGLU.

The counterpart of the JAX package's ``models/layers.py``: pure functions
over parameter dictionaries, the same arithmetic in the same dtypes
(float32 statistics and softmax state, everything else in the
activations' dtype).  The reference's sharding constraints are dropped:
the port has no mesh yet.

Attention keeps the reference's masking exactly, and its NEG_INF is
**finite** (``-1e30``) on purpose: a query row with no live key (a row
inside a left pad, during prefill) gets a uniform softmax over its
masked cache and so a finite mean of V, as in the reference.  That row
then goes on through the MoE router and takes capacity slots, so the
serving engine's poison counts and surviving tokens depend on it.  The
port's ``flash_attention`` / ``paged_attention`` kernels return zeros for
such rows (right for the kernel API) and are therefore not used here;
the reference's model stack does not call its Pallas attention kernels
either.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); pos: (T,) or (B, T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # (..., T, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks (a loop for ``lax.scan``).

    q, k, v: (B, H, T, d) with equal head counts: the caller expands GQA.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    assert hkv == hq, "expand GQA heads before chunked_attention"
    scale = 1.0 / (d ** 0.5)
    chunk = min(chunk, tk)
    n_chunks = -(-tk // chunk)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full((b, hq, tq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, tq, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kc = k[:, :, ci * chunk:(ci + 1) * chunk]
        vc = v[:, :, ci * chunk:(ci + 1) * chunk]
        if kc.shape[2] < chunk:  # the reference zero-pads the last chunk
            pad = chunk - kc.shape[2]
            kc = F.pad(kc, (0, 0, 0, pad))
            vc = F.pad(vc, (0, 0, 0, pad))
        s = (q @ kc.transpose(-1, -2)).float() * scale
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        valid = k_pos < tk
        if causal:
            valid = valid[None, :] & (k_pos[None, :] <= q_pos[:, None])
        s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + (p.to(vc.dtype) @ vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def gqa_attention(params: Dict, x: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, theta: float,
                  pos_offset: int = 0, kv_cache: Optional[Tuple] = None,
                  cache_len: int = 0, causal: bool = True,
                  pad_len: Optional[torch.Tensor] = None):
    """GQA attention block (pre-norm outside).  Returns (out, new_kv).

    kv_cache: (k, v) of shape (B, Hkv, Tmax, hd); the new keys and values
    are written at ``cache_len`` **in place** (the reference returns
    updated copies; every caller here owns its cache) and the queries
    attend over the valid prefix.  pad_len: (B,) int32, per-row left-pad
    length: RoPE positions count real tokens only and the pad columns are
    masked out of every attention read.
    """
    b, t, dm = x.shape
    rep = n_heads // n_kv_heads
    q = (x @ params["wq"]).view(b, t, n_heads, head_dim)
    k = (x @ params["wk"]).view(b, t, n_kv_heads, head_dim)
    v = (x @ params["wv"]).view(b, t, n_kv_heads, head_dim)
    pos = pos_offset + torch.arange(t, device=x.device)
    if pad_len is not None:
        # per-row real-token positions; pad rows clamp to 0 but are masked
        # out of attention below, so their rotation is dead
        pos = torch.clamp(pos[None, :] - pad_len[:, None].long(), min=0)
    q = rope(q, pos, theta).transpose(1, 2)                 # (B, H, T, hd)
    k = rope(k, pos, theta).transpose(1, 2)
    v = v.transpose(1, 2)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_len + t > ck.shape[2]:
            raise ValueError(f"{t} tokens at {cache_len} overflow a cache "
                             f"of {ck.shape[2]}")
        ck[:, :, cache_len:cache_len + t] = k.to(ck.dtype)
        cv[:, :, cache_len:cache_len + t] = v.to(cv.dtype)
        new_cache = (ck, cv)
        cke = ck.repeat_interleave(rep, dim=1) if rep > 1 else ck
        cve = cv.repeat_interleave(rep, dim=1) if rep > 1 else cv
        out = _decode_attention(q, cke, cve, cache_len + t, pad_len=pad_len)
        out = out.reshape(b, t, n_heads * head_dim)
    else:
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        out = chunked_attention(q, k, v, causal=causal, q_offset=pos_offset)
        out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
    return out @ params["wo"], new_cache


def _decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      valid_len: int,
                      pad_len: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Few-token attention over a (B, H, Tmax, d) cache with a validity
    mask: the full cache is read, columns past the end are masked, the new
    tokens attend causally among themselves.  ``pad_len`` ((B,) int32)
    also masks the left-pad columns at the start of the cache.  Returns
    (B, t, H, d)."""
    b, hq, t, d = q.shape
    assert ck.shape[1] == hq, "expand GQA heads before _decode_attention"
    s = (q @ ck.transpose(-1, -2)).float()
    s = s / (d ** 0.5)
    k_pos = torch.arange(ck.shape[2], device=q.device)          # (Tmax,)
    q_pos = valid_len - t + torch.arange(t, device=q.device)    # (t,)
    ok = k_pos[None, :] <= q_pos[:, None]                       # (t, Tmax)
    if pad_len is not None:
        alive = k_pos[None, :] >= pad_len[:, None].long()       # (B, Tmax)
        ok = (ok[None] & alive[:, None])[:, None]               # (B,1,t,T)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = p.to(cv.dtype) @ cv
    return out.transpose(1, 2)
