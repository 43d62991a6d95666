"""Plain PyTorch versions of the kernels (the semantic ground truth).

Semantics follow the reference oracle of the JAX package: a *negative
index* marks a mis-speculated request — a gather returns a zero row for
it, a scatter drops it, attention leaves it out of the softmax — and an
index of at least the row count clips to the last row.  Arithmetic
follows the Pallas kernels: float32 accumulation and softmax state, the
output in the input's dtype.  The SSM scans are the port's first
versions of the reference's ``lax.scan`` loops, one step a token, and
``chunked_attention`` the reference's loop over key chunks.  The
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


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64 (the loops'
    float32 steps, so that a float64 run stays float64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _rwkv6_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``k_tᵀ v_t`` of one token (B, H, hd) pair as the loop forms it: the
    outer product in the activations' dtype, then float32."""
    return _wide(k[..., :, None] * v[..., None, :])


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s: torch.Tensor):
    """The RWKV-6 recurrence over time, one step a token.  r, k, v, w:
    (B, T, H, hd); u: (H, hd); s: (B, H, hd, hd) float32.  Returns the
    last state and the outputs (B, T, H, hd) in r's dtype.

    Each step rounds where the reference's ``lax.scan`` step, as XLA runs
    it, rounds: k·v in the activations' dtype, then float32; the state
    plus u·kv cast to r's dtype for the read-out, whose product sums in
    float32 and rounds once; the state update in float32.  Given float64
    throughout, it runs in float64."""
    ub = u[None, :, :, None]
    outs = []
    for i in range(r.shape[1]):
        rt, kt, vt, wt = r[:, i], k[:, i], v[:, i], w[:, i]
        kv = _rwkv6_kv(kt, vt)
        outs.append((rt[..., None, :] @ (s + ub * kv).to(rt.dtype))[..., 0, :])
        s = _wide(wt[..., None]) * s + kv
    return s, torch.stack(outs, dim=1)


def mamba_scan(u: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, s: torch.Tensor):
    """The Mamba recurrence over time, one step a token.  u: (B, T, D);
    delta: (B, T, 1); bmat, cmat: (B, T, N); a: (D, N) float32; s:
    (B, D, N) float32.  Returns the last state and the outputs (B, T, D)
    in cmat's dtype.  exp(Δ·A) and the state are float32, Δ·u rounds to
    the activations' dtype, the read-out takes the state in cmat's dtype
    and sums in float32.  Given float64 throughout, it runs in float64."""
    ys = []
    for i in range(u.shape[1]):
        ut, dt, bt, ct = u[:, i], delta[:, i], bmat[:, i], cmat[:, i]
        da = torch.exp(dt[..., None] * a[None])               # (B, D, N)
        # dt·u in the activations' dtype; its product with B joins the
        # float32 state unrounded, as the reference's fused step computes
        # it (XLA keeps the fused product in float32)
        s = da * s + _wide(dt * ut)[..., None] * _wide(bt)[:, None, :]
        ys.append((s.to(ct.dtype) @ ct[..., None])[..., 0])
    return s, torch.stack(ys, dim=1)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as the card's fused
    multiply-add (``fmaf``) rounds it.  The product is exact in float64;
    the sum takes float64's nearest value, and where that was inexact and
    its last bit is even it moves one float64 step towards the exact sum
    (rounding to odd), so that the final rounding to float32 is the single
    rounding of the exact value, never a double one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    # the error of s, exactly (Knuth's two-sum)
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


#: row lanes of the RWKV-6 step forward at T >= 2 (rwkv6_step_fwd_kernel),
#: and the tree in which their partial sums of y meet
RWKV6_STEP_LANES = 8
RWKV6_STEP_TREE = ((0, 4, 2, 6), (1, 5, 3, 7))


def rwkv6_scan_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                    chunk: int = 32):
    """:func:`rwkv6_scan` with y summed as the card's step forward at T >=
    2 sums it (``rwkv6_step_fwd_kernel`` in ``csrc/rwkv6_scan.cu``), for
    tests; the kernels' wrappers never call it.  The state and the
    read-out's operand ``M = S + u·kv`` round as the loop's do, so the
    state is the loop's bit for bit.  ``y_t[j] = Σ_i r_t[i] M[i, j]``:
    row lane l of 8 sums rows ``l·hd/8 .. (l+1)·hd/8 - 1`` in order, in one
    chain of :func:`fma32` from 0, and the lanes' partial sums P_l meet as
    ``((P0 + P4) + (P2 + P6)) + ((P1 + P5) + (P3 + P7))`` in float32;
    then y rounds once to r's dtype.  The read-outs of ``chunk`` tokens
    run side by side.  float32 and bfloat16 only."""
    ub = u[None, :, :, None]
    tr = r.shape[-1] // RWKV6_STEP_LANES
    outs, ms = [], []

    def read_out(t1):
        # (B, tokens, H, lane, row of the lane[, column]): the tokens'
        # lanes side by side
        m = torch.stack(ms, dim=1).unflatten(-2, (RWKV6_STEP_LANES, tr))
        rf = r[:, t1 - len(ms):t1].float().unflatten(
            -1, (RWKV6_STEP_LANES, tr))
        acc = torch.zeros_like(m[..., 0, :])
        for x in range(tr):
            acc = fma32(rf[..., x, None], m[..., x, :], acc)
        half = [(acc[..., a, :] + acc[..., b, :]) + (acc[..., c, :]
                                                     + acc[..., d, :])
                for a, b, c, d in RWKV6_STEP_TREE]
        outs.append((half[0] + half[1]).to(r.dtype))
        ms.clear()

    for i in range(r.shape[1]):
        rt, kt, vt, wt = r[:, i], k[:, i], v[:, i], w[:, i]
        kv = _rwkv6_kv(kt, vt)
        ms.append((s + ub * kv).to(rt.dtype).float())     # (B, H, hd, hd)
        s = _wide(wt[..., None]) * s + kv
        if len(ms) == chunk or i + 1 == r.shape[1]:
            read_out(i + 1)
    return s, torch.cat(outs, dim=1)


def mamba_scan_step(u: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                    chunk: int = 64):
    """:func:`mamba_scan` with y summed as the card's step and decode
    kernels sum it (``mamba_fwd_kernel``, ``mamba_decode_kernel`` in
    ``csrc/mamba_scan.cu``), for tests: ``y_t = Σ_n round(s_t[n]) C_t[n]``
    in one chain of :func:`fma32` over n = 0 .. N - 1 from 0, rounded once
    to cmat's dtype; the read-outs of ``chunk`` steps side by side.  The
    state is the loop's (the same operations); float32 and bfloat16
    only."""
    ys, srs = [], []

    def read_out(t1):
        sr = torch.stack(srs, dim=1)                      # (B, steps, D, N)
        cf = cmat[:, t1 - len(srs):t1].float()[:, :, None, :].expand_as(sr)
        acc = torch.zeros_like(sr[..., 0])
        for n in range(sr.shape[-1]):
            acc = fma32(sr[..., n], cf[..., n], acc)
        ys.append(acc.to(cmat.dtype))
        srs.clear()

    for i in range(u.shape[1]):
        ut, dt, bt, ct = u[:, i], delta[:, i], bmat[:, i], cmat[:, i]
        da = torch.exp(dt[..., None] * a[None])
        s = da * s + _wide(dt * ut)[..., None] * _wide(bt)[:, None, :]
        srs.append(s.to(ct.dtype).float())
        if len(srs) == chunk or i + 1 == u.shape[1]:
            read_out(i + 1)
    return s, torch.cat(ys, dim=1)


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


def rwkv6_scan_bwd_step(r, k, v, w, u, s, ds, dy, unit: int = 32,
                        keep: list | None = None):
    """The gradients of :func:`rwkv6_scan` by the step backward's passes,
    with the step's roundings: the algorithm of the ``step`` backward
    pair in ``csrc/rwkv6_scan.cu`` (``unit = 32``), for tests; the
    kernels' wrappers never call it.  Arguments and results as
    :func:`rwkv6_scan_bwd_chunked`'s.  Every state it rebuilds is the
    loop's bit for bit (kv in the activations' dtype, the update in
    float32); ``keep``, if given, receives S_{t-1} of every step in
    order.  Gradients sum in float32 and round once.

    1. The state entering every ``unit`` tokens, step by step forward.
    2. The state's cotangent leaving every unit, step by step backward:
       ``G_{t-1} = diag(w_t) G_t + r_tᵀ dy_t``, no state needed; the
       last one is the first state's gradient.
    3. Each unit alone: its states rebuilt from the one entering it, then
       walked back from the cotangent leaving it, with M = S_{t-1} +
       diag(u) kv rounded to r's dtype as the read-out rounds it:

       dr_t = M dy_t        dw_t = Σ_j G_t ∘ S_{t-1}     dM = r_tᵀ dy_t
       dk_t = (G_t + u dM) v_t        dv_t = k_t (G_t + u dM)
       du  += Σ_j dM ∘ kv             G_{t-1} = diag(w_t) G_t + dM
    """
    dtype, udtype = r.dtype, u.dtype
    b, t, h, hd = r.shape
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    ucol = u.float()[None, :, :, None]                   # (1, H, hd, 1)
    n_u = -(-t // unit)
    # 1. the state entering each unit
    enter, st = [], s.float()
    for i in range(t):
        if i % unit == 0:
            enter.append(st)
        st = wf[:, i][..., None] * st + _rwkv6_kv(k[:, i], v[:, i])
    # 2. the cotangent leaving each unit
    leave = [None] * n_u
    g = torch.zeros_like(s, dtype=torch.float32) if ds is None else \
        ds.float()
    for i in reversed(range(t)):
        if i == t - 1 or i % unit == unit - 1:
            leave[i // unit] = g
        g = wf[:, i][..., None] * g + rf[:, i][..., None] * \
            dyf[:, i][..., None, :]
    ds0 = g
    # 3. each unit alone
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros(h, hd, dtype=torch.float32, device=r.device)
    for n in range(n_u):
        t0, t1 = n * unit, min((n + 1) * unit, t)
        prev, st = [], enter[n]
        for i in range(t0, t1):
            prev.append(st)
            st = wf[:, i][..., None] * st + _rwkv6_kv(k[:, i], v[:, i])
        if keep is not None:
            keep.extend(prev)
        g = leave[n]
        for i in reversed(range(t0, t1)):
            sp = prev[i - t0]
            kv = _rwkv6_kv(k[:, i], v[:, i])
            m = (sp + ucol * kv).to(dtype).float()
            dyt = dyf[:, i][..., None, :]
            dm = rf[:, i][..., None] * dyt
            dkv = g + ucol * dm
            dr[:, i] = (m * dyt).sum(-1)
            dw[:, i] = (g * sp).sum(-1)
            dk[:, i] = (dkv * vf[:, i][..., None, :]).sum(-1)
            dv[:, i] = (dkv * kf[:, i][..., None]).sum(-2)
            du += (dm * kv).sum((0, -1))
            g = wf[:, i][..., None] * g + dm
    return (*(x.to(dtype) for x in (dr, dk, dv, dw)), du.to(udtype), ds0)


def mamba_scan_bwd_step(u, delta, bmat, cmat, a, s, ds, dy,
                        unit: int = 32, keep: list | None = None):
    """The gradients of :func:`mamba_scan` by the step backward's passes,
    with the step's roundings: the algorithm of the ``step`` backward
    pair in ``csrc/mamba_scan.cu`` (``unit = 32``), for tests; the
    kernels' wrappers never call it.  Arguments and results as
    :func:`mamba_scan_bwd_chunked`'s.  Every state it rebuilds is the
    loop's bit for bit (Δ·u rounded to the activations' dtype, exp(Δ·a)
    and the update in float32); ``keep``, if given, receives s_{t-1} of
    every step in order.  dC takes the state rounded to C's dtype, as
    the read-out does; the other roundings count as the identity.

    1. The state entering every ``unit`` steps, step by step forward.
    2. The state's cotangent leaving every unit, step by step backward
       (``h <- exp(Δ_t a) (h + dy_t C_t)``, no state needed); the last
       one is the first state's gradient.
    3. Each unit alone: its states rebuilt from the one entering it, then
       walked back from the cotangent leaving it (the sums over channels
       of dB, dC and ddelta, and da's over time and the batch).
    """
    b, t, d = u.shape
    uf, dl, bm, cm, dyf = (x.float() for x in (u, delta, bmat, cmat, dy))
    x = _wide(delta * u)                                 # (B, T, D)
    e = torch.exp(dl[..., None] * a[None, None])         # (B, T, D, N)

    def step(st, i):
        return e[:, i] * st + x[:, i, :, None] * bm[:, i, None, :]

    n_u = -(-t // unit)
    enter, st = [], s.float()
    for i in range(t):
        if i % unit == 0:
            enter.append(st)
        st = step(st, i)
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
            st = step(st, i)
        if keep is not None:
            keep.extend(prev)
        hc = leave[n]
        for i in reversed(range(t0, t1)):
            sp = prev[i - t0]
            s_t = step(sp, i).to(cmat.dtype).float()
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


#: the reference's finite mask value (``repro.models.layers.NEG_INF``)
NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 512, q_offset: int = 0,
                      return_lse: bool = False,
                      scale: float | None = None):
    """Online-softmax attention over key chunks: the reference's
    ``lax.scan`` in ``chunked_attention`` as a loop, one step a chunk.

    q, k, v: (B, H, T, d) with equal head counts (the caller expands
    GQA).  The causal key j counts for query i iff j <= q_offset + i;
    keys past Tk (the reference zero-pads the last chunk) are masked with
    the finite ``NEG_INF``.  Each step rounds where the reference's
    rounds: q·k in the inputs' dtype, then float32 and scaled; p rounded
    to v's dtype for its product, whose result is then float32; m, l and
    the accumulator float32.  Returns the output in q's dtype, and with
    ``return_lse`` also the per-row log-sum-exp ``m + log l`` (B, H, Tq),
    float32, the statistic :func:`chunked_attention_bwd` takes.
    ``scale`` replaces ``1/√d`` (the tile kernels' zero-padded widths
    keep the true width's)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    assert hkv == hq, "expand GQA heads before chunked_attention"
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    chunk = min(chunk, tk)
    n_chunks = -(-tk // chunk)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    # the running state takes q's layout: on a DTensor its placements, so
    # each rank holds (and the dry run counts) its shard, not q's global
    # shape
    acc = torch.zeros_like(q, dtype=torch.float32)
    m = torch.full_like(acc[..., :1], NEG_INF)
    l = torch.zeros_like(m)
    for ci in range(n_chunks):
        kc = k[:, :, ci * chunk:(ci + 1) * chunk]
        vc = v[:, :, ci * chunk:(ci + 1) * chunk]
        if kc.shape[2] < chunk:  # the reference zero-pads the last chunk
            pad = chunk - kc.shape[2]
            kc = torch.nn.functional.pad(kc, (0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, pad))
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
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def chunked_attention_split(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool, n_splits: int,
                            split_keys: int, q_offset: int = 0,
                            return_lse: bool = False):
    """The split route's arithmetic in float32: the keys cut into
    ``n_splits`` splits of ``split_keys`` (the last one shorter), each
    split's partial (m, l, acc) of every row (m = -inf, l = 0, acc = 0
    where the split holds no live key for the row), then the partials
    combined in split order, skipping those with m = -inf:
    ``out = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s`` with m the
    largest m_s.  Returns the output in q's dtype (and with
    ``return_lse`` the log-sum-exp ``m + log l``, float32), as
    :func:`chunked_attention` does.  Every row needs a live key."""
    tq, d, tk = q.shape[2], q.shape[3], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = (t.float() for t in (q, k, v))
    rows = q_offset + torch.arange(tq, device=q.device)
    parts = []
    for sp in range(n_splits):
        lo, hi = sp * split_keys, min(tk, (sp + 1) * split_keys)
        s = (qf @ kf[:, :, lo:hi].transpose(-1, -2)) * scale
        if causal:
            keys = torch.arange(lo, hi, device=q.device)
            s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
        parts.append((m, p.sum(-1, keepdim=True), p @ vf[:, :, lo:hi]))
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for pm, pl, pacc in parts:  # in split order
        a = torch.where(pm == float("-inf"), 0.0, torch.exp(pm - m))
        l = l + a * pl
        acc = acc + a * pacc
    out = (acc / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def chunked_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, dout: torch.Tensor,
                          lse: torch.Tensor, *, causal: bool,
                          q_offset: int = 0,
                          scale: float | None = None):
    """The backward kernels' algorithm in float32: the gradients of q, k
    and v of :func:`chunked_attention`, given its output, the output's
    cotangent and the per-row log-sum-exp.  The probabilities are
    recomputed from ``lse`` (``p = exp(s - lse)``, zero where masked),
    ``D = rowsum(dout * out)``, ``dS = p (dout vᵀ - D)``; then ``dq = dS k
    / √d``, ``dk = dSᵀ q / √d``, ``dv = pᵀ dout``, each in its input's
    dtype.  Every row needs a live key (Tk >= 1, q_offset >= 0).
    ``scale`` replaces ``1/√d``, as in :func:`chunked_attention`."""
    tq, d = q.shape[2], q.shape[3]
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    s = (qf @ kf.transpose(-1, -2)) * scale
    valid = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        valid = (torch.arange(tk, device=q.device)[None, :]
                 <= q_offset + torch.arange(tq, device=q.device)[:, None])
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    delta = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (gf @ vf.transpose(-1, -2) - delta)
    return ((ds @ kf * scale).to(q.dtype),
            (ds.transpose(-1, -2) @ qf * scale).to(k.dtype),
            (p.transpose(-1, -2) @ gf).to(v.dtype))
