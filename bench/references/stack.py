"""Plain float32 reference of a served wave: attention and MoE.

It reads only the weights the benchmark drew and the tokens of one wave,
and follows the published description of each layer as the port's
configuration states it, with every matmul in float32 (TF32 off).  It
imports nothing of the program.

What a wave is, as the serving engine defines it (and this reference
works out again from the prompts): the prompts left-padded with token 0
to the longest, then one column a decode step.  The pad columns are
masked out of every attention read and RoPE counts real tokens only; a
query inside a row's pad has no live key and takes a uniform softmax
over the whole cache of ``max_len`` columns, of which only the prefill's
are filled.  The MoE routes every
token (pads too) and takes its dispatch requests in row-major (token,
choice) order, one group for the prefill and one for each decode step:
a request whose place in its expert reaches the group's capacity is
poisoned and adds nothing.

The whole wave runs as one full forward pass over its columns, no cache.
``quant="fp8"`` is the control: every weight matmul takes its operands
through float8 e4m3 (a scale a row for activations, one a tensor for
weights) and computes in float32.  ``quant="bf16"`` is a witness of the
served precision: each weight matmul's input and output and the residual
stream are rounded to bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
EPS = 1e-6


def _q8(x: torch.Tensor, rows: bool) -> torch.Tensor:
    amax = x.abs().amax(dim=-1, keepdim=True) if rows else x.abs().amax()
    scale = (amax / E4M3_MAX).clamp(min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    wf = w.float()
    if quant == "fp8":
        return _q8(a, rows=True) @ _q8(wf, rows=False)
    if quant == "bf16":
        return _bf(_bf(a) @ wf)
    return a @ wf


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, C, H, hd); pos: (B, C) real-token positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(h, wg, wu, wd, quant):
    return _mm(F.silu(_mm(h, wg, quant)) * _mm(h, wu, quant), wd, quant)


def attention(p: Dict, h: torch.Tensor, wave: Dict, port: Dict,
              quant) -> torch.Tensor:
    b, c, d = h.shape
    nh, nkv = port["n_heads"], port["n_kv_heads"]
    hd = port.get("head_dim") or d // nh
    pads = wave["pads"]
    cols = torch.arange(c, device=h.device)
    pos = (cols[None] - pads[:, None]).clamp(min=0)
    q = rope(_mm(h, p["wq"], quant).view(b, c, nh, hd), pos,
             port["rope_theta"])
    k = rope(_mm(h, p["wk"], quant).view(b, c, nkv, hd), pos,
             port["rope_theta"])
    v = _mm(h, p["wv"], quant).view(b, c, nkv, hd)
    rep = nh // nkv
    out = torch.empty((b, c, nh, hd), dtype=torch.float32, device=h.device)
    causal = cols[None, :] <= cols[:, None]
    for r in range(b):
        pad = int(pads[r])
        qr = q[r].transpose(0, 1)                          # (H, C, hd)
        kr = k[r].transpose(0, 1).repeat_interleave(rep, 0)
        vr = v[r].transpose(0, 1).repeat_interleave(rep, 0)
        s = (qr @ kr.transpose(-1, -2)) / math.sqrt(hd)
        live = causal & (cols[None, :] >= pad)
        live[:pad, 0] = True        # pad queries: filled in below
        s.masked_fill_(~live, float("-inf"))
        o = torch.softmax(s, dim=-1) @ vr                  # (H, C, hd)
        if pad:
            # no live key: uniform over the prefill's max_len cache
            o[:, :pad] = (vr[:, :wave["plen"]].sum(1)
                          / wave["max_len"])[:, None]
        out[r] = o.transpose(0, 1)
        del s, o, live
    return _mm(out.view(b, c, nh * hd), p["wo"], quant)


def round_capacity(n_tokens: int, n_experts: int, top_k: int,
                   factor: float, multiple: int = 8) -> int:
    cap = int(factor * n_tokens * top_k / n_experts) + 1
    return max(multiple, ((cap + multiple - 1) // multiple) * multiple)


def _places(keys: torch.Tensor) -> torch.Tensor:
    """Each request's 0-based place among the earlier requests with its
    key, requests in order."""
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    first = torch.searchsorted(sk, sk)
    place = torch.empty_like(keys)
    place[order] = torch.arange(keys.numel(), device=keys.device) - first
    return place


def moe(p: Dict, h: torch.Tensor, wave: Dict, port: Dict, quant,
        stats: Dict) -> torch.Tensor:
    b, c, d = h.shape
    e_n, k = port["n_experts"], port["top_k"]
    cf = port.get("capacity_factor", 1.25)
    probs = torch.softmax(_mm(h, p["router"], quant), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :k].clone(), experts[..., :k]
    plen = wave["plen"]
    groups = [(slice(0, plen), b * plen)] + [
        (slice(col, col + 1), b) for col in range(plen, c)]
    for cols, n in groups:
        keys = experts[:, cols].reshape(-1)
        place = _places(keys).view(b, -1, k)
        poison = place >= round_capacity(n, e_n, k, cf)
        stats["poison"] = stats.get("poison", 0) + int(poison.sum())
        g = gates[:, cols]
        g[poison] = 0.0
        gates[:, cols] = g
    hf = h.reshape(-1, d)
    fe = experts.reshape(-1)
    fg = gates.reshape(-1)
    tok = torch.arange(hf.shape[0], device=h.device).repeat_interleave(k)
    keep = fg != 0
    fe, fg, tok = fe[keep], fg[keep], tok[keep]
    order = torch.sort(fe, stable=True).indices
    fe, fg, tok = fe[order], fg[order], tok[order]
    bounds = torch.searchsorted(
        fe, torch.arange(e_n + 1, device=h.device)).tolist()
    out = torch.zeros_like(hf)
    for e in range(e_n):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        rows = tok[lo:hi]
        y = swiglu(hf[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                   quant)
        out.index_add_(0, rows, y * fg[lo:hi, None])
    if "shared_w_gate" in p:
        out += swiglu(hf, p["shared_w_gate"], p["shared_w_up"],
                      p["shared_w_down"], quant)
    return out.view(b, c, d)


def final_hidden(params: Dict, port: Dict, pattern: Sequence[str],
                 wave: Dict, quant: Optional[str] = None,
                 stats: Optional[Dict] = None) -> torch.Tensor:
    """The wave's hidden states after the last group, (B, C, d) float32,
    before the final norm.  ``wave``: ``tokens`` (B, C) int64 on the
    weights' device, ``pads`` (B,), ``plen``, ``max_len``."""
    stats = {} if stats is None else stats
    x = params["embed"][wave["tokens"]].float()
    for group in params["groups"]:
        for j, kind in enumerate(pattern):
            p = group[f"s{j}_{kind}"]
            h = rms_norm(x, p["ln"])
            if kind == "attn":
                out = attention(p, h, wave, port, quant)
            elif kind == "moe":
                out = moe(p, h, wave, port, quant, stats)
            else:
                raise ValueError(kind)
            x = x + out
            if quant == "bf16":
                x = _bf(x)
            del h, out
    return x


def head_logits(params: Dict, hidden: torch.Tensor, quant=None,
                reads: Optional[List[torch.Tensor]] = None,
                block: int = 16384) -> Dict:
    """Logits of the final-norm ``hidden`` (P, d) over the vocabulary, in
    blocks of columns: each row's best logit and its token, and the
    logits at the token ids of each tensor in ``reads`` ((P,) each)."""
    h = rms_norm(hidden, params["ln_f"])
    w = params["lm_head"]
    best = torch.full((h.shape[0],), float("-inf"), device=h.device)
    arg = torch.zeros((h.shape[0],), dtype=torch.long, device=h.device)
    reads = reads or []
    got = [torch.zeros((h.shape[0],), device=h.device) for _ in reads]
    hq = h if quant != "fp8" else _q8(h, rows=True)
    wscale = None
    if quant == "fp8":
        wscale = (w.float().abs().amax() / E4M3_MAX).clamp(min=1e-30)
    for lo in range(0, w.shape[1], block):
        wb = w[:, lo:lo + block].float()
        if quant == "fp8":
            wb = (wb / wscale).to(torch.float8_e4m3fn).float() * wscale
        lg = hq @ wb
        m, i = lg.max(-1)
        better = m > best
        best = torch.where(better, m, best)
        arg = torch.where(better, i + lo, arg)
        for g, ids in zip(got, reads):
            inside = (ids >= lo) & (ids < lo + wb.shape[1])
            col = (ids - lo).clamp(0, wb.shape[1] - 1)
            g += torch.where(inside, lg.gather(1, col[:, None])[:, 0],
                             torch.zeros((), device=h.device))
    return {"best": best, "argmax": arg, "reads": got}
