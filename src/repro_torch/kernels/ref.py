"""Plain PyTorch versions of the kernels (the semantic ground truth).

Semantics follow the reference oracle of the JAX package: a *negative
index* marks a mis-speculated request — a gather returns a zero row for
it, a scatter drops it, attention leaves it out of the softmax — and an
index of at least the row count clips to the last row.  Arithmetic
follows the Pallas kernels: float32 accumulation and softmax state, the
output in the input's dtype.  The SSM scans are the port's first
versions of the reference's ``lax.scan`` loops, one step a token.  The
kernel wrappers run these on CPU tensors; on the card they are what the CUDA kernels are held against.
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


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s: torch.Tensor):
    """The RWKV-6 recurrence over time, one step a token.  r, k, v, w:
    (B, T, H, hd); u: (H, hd); s: (B, H, hd, hd) float32.  Returns the
    last state and the outputs (B, T, H, hd) in r's dtype.

    Each step rounds where the reference's ``lax.scan`` step, as XLA runs
    it, rounds: k·v in the activations' dtype, then float32; the state
    plus u·kv cast to r's dtype for the read-out, whose product sums in
    float32 and rounds once; the state update in float32."""
    ub = u[None, :, :, None]
    outs = []
    for i in range(r.shape[1]):
        rt, kt, vt, wt = r[:, i], k[:, i], v[:, i], w[:, i]
        # the outer product in the activations' dtype, then float32
        kv = (kt[..., :, None] * vt[..., None, :]).float()
        outs.append((rt[..., None, :] @ (s + ub * kv).to(rt.dtype))[..., 0, :])
        s = wt[..., None].float() * s + kv
    return s, torch.stack(outs, dim=1)


def mamba_scan(u: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, s: torch.Tensor):
    """The Mamba recurrence over time, one step a token.  u: (B, T, D);
    delta: (B, T, 1); bmat, cmat: (B, T, N); a: (D, N) float32; s:
    (B, D, N) float32.  Returns the last state and the outputs (B, T, D)
    in cmat's dtype.  exp(Δ·A) and the state are float32, Δ·u rounds to
    the activations' dtype, the read-out takes the state in cmat's dtype
    and sums in float32."""
    ys = []
    for i in range(u.shape[1]):
        ut, dt, bt, ct = u[:, i], delta[:, i], bmat[:, i], cmat[:, i]
        da = torch.exp(dt[..., None] * a[None])               # (B, D, N)
        # dt·u in the activations' dtype; its product with B joins the
        # float32 state unrounded, as the reference's fused step computes
        # it (XLA keeps the fused product in float32)
        s = da * s + (dt * ut).float()[..., None] * bt.float()[:, None, :]
        ys.append((s.to(ct.dtype) @ ct[..., None])[..., 0])
    return s, torch.stack(ys, dim=1)


def _excl_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Products of ``x`` over dim 1 before each position (1 at the first):
    taken directly, never as a quotient."""
    return torch.cat([torch.ones_like(x[:, :1]),
                      torch.cumprod(x, dim=1)[:, :-1]], dim=1)


def rwkv6_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                       chunk: int = 16, sub: int = 16):
    """The RWKV-6 recurrence in chunked form, in float32: the algorithm of
    the ``chunked`` route (``csrc/rwkv6_chunk_sm90.cu``, which carries the
    state every 16 tokens: ``chunk = sub = 16``), for tests; the kernels'
    wrappers never call it.  Arguments and results as
    :func:`rwkv6_scan`'s; y comes back in r's dtype.

    The state enters each chunk of ``chunk`` tokens once: its read-out is
    ``(r_t ⊙ Π_{τ<t} w_τ) S`` and its update ``diag(Π_τ w_τ) S + Σ_s (k_s ⊙
    Π_{τ>s} w_τ)ᵀ v_s``.  Inside a chunk, token t reads token s < t with
    the score ``Σ_i r_t[i] k_s[i] Π_{s<τ<t} w_τ[i]`` and itself with the
    bonus ``Σ_i r_t[i] u[i] k_t[i]``.  Pairs within one sub-chunk of
    ``sub`` tokens take their decays elementwise; a pair across sub-chunks
    splits its decay at the start b of t's sub-chunk, ``Π_{b≤τ<t} ·
    Π_{s<τ<b}``, so a score block is one product of two decayed matrices.
    Every decay is a product of w's taken directly: at most 1 for w ≤ 1,
    exact zeros for w = 0, no quotient and no log, so nothing overflows
    and no log-w floor is needed."""
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of sub {sub}")
    dtype = r.dtype
    r, k, v, w = (x.float() for x in (r, k, v, w))
    uf = u.float()
    s = s.float()
    outs = []
    for c0 in range(0, r.shape[1], chunk):
        rc, kc, vc, wc = (x[:, c0:c0 + chunk] for x in (r, k, v, w))
        n = rc.shape[1]
        pre = _excl_cumprod(wc)                                # Π_{τ<t}
        post = _excl_cumprod(wc.flip(1)).flip(1)               # Π_{τ>s}
        y = torch.einsum("bthi,bhij->bthj", rc * pre, s)
        scores = rc.new_zeros(rc.shape[0], rc.shape[2], n, n)  # (B, H, t, s)
        for q0 in range(0, n, sub):
            q1 = min(q0 + sub, n)
            for t in range(q0, q1):
                d = torch.ones_like(rc[:, t])
                for j in range(t - 1, q0 - 1, -1):
                    scores[:, :, t, j] = (rc[:, t] * kc[:, j] * d).sum(-1)
                    d = d * wc[:, j]
                scores[:, :, t, t] = (rc[:, t] * uf * kc[:, t]).sum(-1)
            if q0:
                a_q = rc[:, q0:q1] * _excl_cumprod(wc[:, q0:q1])
                k_q = kc[:, :q0] * _excl_cumprod(wc[:, :q0].flip(1)).flip(1)
                scores[:, :, q0:q1, :q0] = torch.einsum("bthi,bshi->bhts",
                                                        a_q, k_q)
        outs.append(y + torch.einsum("bhts,bshj->bthj", scores, vc))
        decay = pre[:, -1] * wc[:, -1]                         # Π_τ w_τ
        s = decay[..., None] * s + torch.einsum("bshi,bshj->bhij",
                                                kc * post, vc)
    return s, torch.cat(outs, dim=1).to(dtype)


def _suffix_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Products of ``x`` over dim 1 after each position (1 at the last)."""
    return _excl_cumprod(x.flip(1)).flip(1)


def _chunk_update(st: torch.Tensor, a: torch.Tensor, vv: torch.Tensor,
                  wc: torch.Tensor, suffix: bool) -> torch.Tensor:
    """One chunk of an RWKV-6 boundary pass: ``diag(Π w) st + (a ⊙ d)ᵀ
    vv`` with d the products of w after each token (``suffix``: the
    state, forward) or before it (the cotangent, backward).  a, vv, wc:
    (B, C, H, hd) float32; st: (B, H, hd, hd)."""
    dec = _suffix_cumprod(wc) if suffix else _excl_cumprod(wc)
    total = torch.prod(wc, dim=1)                                # (B, H, hd)
    return total[..., None] * st + torch.einsum("bshi,bshj->bhij", a * dec,
                                                vv)


def _pair_decays(wc: torch.Tensor) -> torch.Tensor:
    """``D[s, t] = Π_{s<τ<t} w_τ`` for s < t, 0 elsewhere, per channel,
    each a direct product: wc (B, H, C, hd) -> (B, H, C, C, hd)."""
    n = wc.shape[2]
    d = wc.new_zeros(wc.shape[:2] + (n, n) + wc.shape[3:])
    for t in range(1, n):
        d[:, :, :t - 1, t] = d[:, :, :t - 1, t - 1] * wc[:, :, t - 1, None]
        d[:, :, t - 1, t] = 1.0
    return d


def rwkv6_scan_bwd_chunked(r, k, v, w, u, s, ds, dy, chunk: int = 16,
                           unit: int = 64):
    """The gradients of :func:`rwkv6_scan` by the chunked backward's
    passes, in float32: the algorithm of ``csrc/rwkv6_chunk_bwd_sm90.cu``
    (``chunk = 16``, ``unit = 64``), for tests; the kernels' wrappers
    never call it.  ``ds`` (the last state's cotangent, or None) and
    ``dy`` (y's) given, returns the gradients of r, k, v, w (r's dtype),
    u (u's dtype) and s (float32), as the step kernels' backward does,
    with the forward's roundings taken as the identity.

    1. The state entering every ``unit`` tokens, chunk by chunk forward:
       ``S <- diag(Π w) S + (k ⊙ Π_{τ>s} w)ᵀ v``.
    2. The state's cotangent leaving every unit, chunk by chunk backward:
       ``G <- diag(Π w) G + (r ⊙ Π_{τ<s} w)ᵀ dy`` (the kernel's step
       ``G_{t-1} = diag(w_t) G_t + r_tᵀ dy_t`` over a chunk); the last
       one is the first state's gradient.
    3. Each unit alone, its chunks from the last: the state entering the
       chunk recomputed from the unit's (S), the cotangent leaving it
       carried (G), and with ``p``, ``q`` the products of w before and
       after each token and ``D[s, t]`` those strictly between:

       dr_t = p_t (S dy_t) + Σ_{s<t} D[s,t] k_s (v_s·dy_t) + u k_t (v_t·dy_t)
       dk_t = q_t (G v_t) + Σ_{s>t} D[t,s] r_s (v_t·dy_s) + u r_t (v_t·dy_t)
       dv_t = (k_t q_t) G + Σ_{s>t} score[s,t] dy_s + bonus_t dy_t
       du   = Σ_t r_t k_t (v_t·dy_t)

       and dw_t = Σ_j G_t[i,j] S_{t-1}[i,j] on the states inside the
       chunk, written through the Gram products of the vectors those
       states are made of (S and G rows, v, dy), never through a
       quotient or a log of w: ``p q (S∘G)1 + q Σ_{s<t} D k (G v_s) + p
       Σ_{s>t} D r (S dy_s) + Σ_{s'<t<s} D[s',t] D[t,s] k_{s'} r_s
       (v_{s'}·dy_s)``.
    """
    if unit % chunk:
        raise ValueError(f"unit {unit} is not a multiple of chunk {chunk}")
    dtype, udtype = r.dtype, u.dtype
    b, t, h, hd = r.shape
    r, k, v, w, dy = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()[None, :, None, :]                     # (1, H, 1, hd)
    n_u = -(-t // unit)
    pad = n_u * unit - t
    if pad:
        r, k, v, dy = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                       for x in (r, k, v, dy))
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    per = unit // chunk
    n_c = n_u * per
    at = [(x[:, c * chunk:(c + 1) * chunk]) for x in (r, k, v, w, dy)
          for c in range(n_c)]
    rc, kc, vc, wc, dyc = (at[i * n_c:(i + 1) * n_c] for i in range(5))
    # 1. the state entering each unit
    enter, st = [], s.float()
    for c in range(n_c):
        if c % per == 0:
            enter.append(st)
        st = _chunk_update(st, kc[c], vc[c], wc[c], suffix=True)
    # 2. the cotangent leaving each unit
    leave = [None] * n_u
    g = torch.zeros_like(s, dtype=torch.float32) if ds is None else \
        ds.float()
    for c in reversed(range(n_c)):
        if c % per == per - 1:
            leave[c // per] = g
        g = _chunk_update(g, rc[c], dyc[c], wc[c], suffix=False)
    ds0 = g
    # 3. each unit, its chunks from the last
    grads = {n: [None] * n_c for n in ("r", "k", "v", "w")}
    du = torch.zeros(h, hd, dtype=torch.float32, device=r.device)
    for n in range(n_u):
        gc = leave[n]
        for j in reversed(range(per)):
            c = n * per + j
            sc = enter[n]
            for i in range(n * per, c):
                sc = _chunk_update(sc, kc[i], vc[i], wc[i], suffix=True)
            rt, kt, vt, wt, dyt = (x[c].transpose(1, 2) for x in
                                   (rc, kc, vc, wc, dyc))  # (B, H, C, hd)
            p, q = _excl_cumprod(wt.transpose(1, 2)).transpose(1, 2), \
                _suffix_cumprod(wt.transpose(1, 2)).transpose(1, 2)
            dm = _pair_decays(wt)                           # (B,H,s,t,hd)
            ds_ = torch.einsum("bhtj,bhij->bhti", dyt, sc)  # S dy_t
            gv = torch.einsum("bhtj,bhij->bhti", vt, gc)    # G v_t
            kg = torch.einsum("bhti,bhij->bhtj", kt * q, gc)
            vdy = torch.einsum("bhsj,bhtj->bhst", vt, dyt)  # v_s · dy_t
            diag = torch.diagonal(vdy, dim1=-2, dim2=-1)[..., None]
            sg = (sc * gc).sum(-1)[:, :, None, :]           # (S∘G)1
            grads["r"][c] = (p * ds_ + torch.einsum(
                "bhsti,bhsi,bhst->bhti", dm, kt, vdy) + uf * kt * diag)
            grads["k"][c] = (q * gv + torch.einsum(
                "bhtsi,bhsi,bhts->bhti", dm, rt, vdy) + uf * rt * diag)
            score = torch.einsum("bhti,bhsi,bhsti->bhts", rt, kt, dm)
            bonus = (rt * uf * kt).sum(-1)
            score = score + torch.diag_embed(bonus)
            grads["v"][c] = kg + torch.einsum("bhst,bhsj->bhtj", score, dyt)
            grads["w"][c] = (
                p * q * sg
                + q * torch.einsum("bhsti,bhsi->bhti", dm, kt * gv)
                + p * torch.einsum("bhtsi,bhsi->bhti", dm, rt * ds_)
                + torch.einsum("bhati,bhtci,bhai,bhci,bhac->bhti", dm, dm,
                               kt, rt, vdy))
            du += (rt * kt * diag).sum((0, 2))
            gc = _chunk_update(gc, rc[c], dyc[c], wc[c], suffix=False)
    out = [torch.cat(grads[n], dim=2).transpose(1, 2)[:, :t].to(dtype)
           for n in ("r", "k", "v", "w")]
    return (*out, du.to(udtype), ds0)


def mamba_scan_bwd_chunked(u, delta, bmat, cmat, a, s, ds, dy,
                           unit: int = 64):
    """The gradients of :func:`mamba_scan` by the chunked backward's
    passes, in float32: the algorithm of the ``chunk`` backward route in
    ``csrc/mamba_scan.cu`` (``unit = 64``), for tests; the kernels'
    wrappers never call it.  Its arithmetic is the ``chunk`` forward
    route's: Δ·u and the read-out's state unrounded, so the forward's
    roundings are taken as the identity.  Returns the gradients of u,
    delta, bmat, cmat (their dtypes), a and s (float32).

    1. The state entering every ``unit`` steps, step by step forward.
    2. The state's cotangent leaving every unit, step by step backward
       (``h <- exp(Δ_t a) (h + dy_t C_t)``); the last one is the first
       state's gradient.
    3. Each unit alone: its states recomputed from the one entering it,
       then walked back from the cotangent leaving it, as the step
       kernels' backward walks (the sums over channels of dB, dC and
       ddelta, and da's over time and the batch, taken per unit).
    """
    b, t, d = u.shape
    uf, dl, bm, cm, dyf = (x.float() for x in (u, delta, bmat, cmat, dy))
    x = dl * uf                                          # (B, T, D)
    e = torch.exp(dl[..., None] * a[None, None])         # (B, T, D, N)
    n_u = -(-t // unit)
    enter, st = [], s.float()
    for i in range(t):
        if i % unit == 0:
            enter.append(st)
        st = e[:, i] * st + x[:, i, :, None] * bm[:, i, None, :]
    leave = [None] * n_u
    g = torch.zeros_like(s, dtype=torch.float32) if ds is None else \
        ds.float()
    for i in reversed(range(t)):
        if i == t - 1 or i % unit == unit - 1:
            leave[i // unit] = g
        g = e[:, i] * (g + dyf[:, i, :, None] * cm[:, i, None, :])
    ds0 = g
    du = torch.zeros_like(uf)
    ddelta = torch.zeros_like(dl)
    dbm, dcm = torch.zeros_like(bm), torch.zeros_like(cm)
    da = torch.zeros_like(a, dtype=torch.float32)
    for n in range(n_u):
        t0, t1 = n * unit, min((n + 1) * unit, t)
        prev, st = [], enter[n]
        for i in range(t0, t1):
            prev.append(st)
            st = e[:, i] * st + x[:, i, :, None] * bm[:, i, None, :]
        hc = leave[n]
        for i in reversed(range(t0, t1)):
            sp = prev[i - t0]
            s_t = e[:, i] * sp + x[:, i, :, None] * bm[:, i, None, :]
            hc = hc + dyf[:, i, :, None] * cm[:, i, None, :]
            dcm[:, i] = (dyf[:, i, :, None] * s_t).sum(1)
            dx = (hc * bm[:, i, None, :]).sum(-1)                # (B, D)
            dbm[:, i] = (hc * x[:, i, :, None]).sum(1)
            gg = hc * sp * e[:, i]
            da += (gg * dl[:, i, :, None]).sum(0)
            ddelta[:, i, 0] = ((gg * a[None]).sum((1, 2))
                               + (dx * uf[:, i]).sum(1))
            du[:, i] = dx * dl[:, i]
            hc = hc * e[:, i]
    return (du.to(u.dtype), ddelta.to(delta.dtype), dbm.to(bmat.dtype),
            dcm.to(cmat.dtype), da, ds0)
