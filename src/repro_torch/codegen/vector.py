"""Vectorised CU execution: epoch drivers for the ``cu-vector`` mode.

The emitted vector CU (:func:`repro.codegen.emit.emit_source`, mode
``cu-vector``) is target-agnostic: it computes whole epochs as batched
numpy expressions and talks to a *driver* for everything that touches
decoupled memory —

* ``plan(loop, remaining)``       — window size in whole iterations
  (:func:`repro.codegen.epochs.plan_iters`);
* ``gather(loop, m)``             — one bulk load covering every array of
  the window, returned as flat iteration-major int lanes per array;
* ``commit(loop, m, body, ld0)``  — the epoch body as a re-evaluable
  closure plus its gathered load estimates.  The driver evaluates the
  body, and when committed stores alias later in-window loads it first
  tries **segmented-scan RAW forwarding** (iterate body evaluation and
  :func:`repro.codegen.epochs.segment_forward` to a fixpoint so the
  epoch need not be cut at all); when forwarding is refused — no
  associative chain, non-integer dtype, address/position legality
  failure, fixpoint non-convergence, scan overflow — it falls back to
  the sound optimistic cut
  (:func:`repro.codegen.epochs.first_violation`).  Either way the
  surviving prefix commits in stream order with write-after-write
  collisions resolved last-writer-wins
  (:func:`repro.codegen.epochs.last_writer_keep`) and same-address runs
  of forwarded arrays collapsed to one row each
  (:func:`repro.codegen.epochs.combine_runs`), and the driver returns
  how many iterations retired plus the matching local-store lanes;
* ``stats()``                     — the state-machine counters
  (committed/poisoned/consumed/leftovers) plus the epoch/forwarding
  counters (``epochs``, ``fwd_epochs``, ``fwd_refusals``).

Two drivers implement the memory operations:

* :class:`_NumpyVectorDriver` — gathers/scatters against private numpy
  working copies (any dtype), written back only after the whole run
  succeeds; forwarded commits use the ``np.add.reduceat`` combine.
* :class:`_TorchVectorDriver` — the decoupled arrays live on device as
  **one fused** ``(n_total, 1)`` int32 table behind per-array base
  offsets, so every epoch is **one** staged ``spec_gather`` plus at most
  one WAW/RAW-resolved staged ``spec_scatter_add`` serving *all* arrays
  (:mod:`repro_torch.kernels.staging`: the requests are written straight
  into a page-locked host slot that the kernels read, and the gathered
  rows come back into it): poisoned slots are ``-1`` indices,
  superseded WAW slots are masked to ``-1`` instead of splitting the
  batch, forwarded same-address runs become a single delta-total row,
  and every add-delta is computed against a fused host mirror of the
  table (exact by induction: the table is only ever mutated by these
  scatters).  Deltas are exact in two's-complement, as in the
  state-machine driver.  An epoch whose stores all poison skips the
  scatter entirely — the DU drops every slot at commit, so the call
  would be a no-op.

Integer lanes are int64 (device gathers are widened host-side before the
body runs, so intermediate arithmetic matches the state machine's
behaviour up to int64 range; the int32 subset check still guards every
committed value).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.spec_gather import spec_gather_staged
from ..kernels.spec_scatter import spec_scatter_add_staged
from ..kernels.staging import Ring
from ..resilience import faults
from ..resilience.faults import FaultDetected
from ..verify.rules import detail_of, tag
from .analysis import CodegenError, UniformLoop, uniform_loops
from .epochs import (I32_MAX as _I32_MAX, I32_MIN as _I32_MIN,
                     MAX_FWD_PASSES, combine_runs, first_violation,
                     last_writer_keep, plan_iters, segment_forward)
from .streams import Streams


# ---------------------------------------------------------------------------
# runtime helpers injected into emitted cu-vector code (lane-wise versions
# of the scalar emitters' int()/bool()-wrapped expression table)
# ---------------------------------------------------------------------------


def _is_arr(*xs) -> bool:
    return any(isinstance(x, np.ndarray) for x in xs)


def _int_arr(*xs) -> bool:
    """True when every operand is integral AND at least one is an int
    ndarray — the combination whose +,-,* would silently wrap at int64
    (floats don't wrap; scalar-scalar stays exact Python)."""
    has = False
    for x in xs:
        if isinstance(x, np.ndarray):
            if x.dtype.kind not in "iu":
                return False
            has = True
        elif isinstance(x, (float, np.floating)):
            return False
    return has


def _overflow() -> "CodegenError":
    return CodegenError(tag(
        "V03-lane-overflow",
        "vector lane overflow: an intermediate exceeds int64 (the "
        "state-machine emitters compute in unbounded Python ints)"))


def _vadd(a, b):
    if not _int_arr(a, b):
        return a + b
    try:
        c = np.add(a, b)
        # two's-complement add overflow: result sign differs from both
        if (((a ^ c) & (b ^ c)) < 0).any():
            raise _overflow()
    except OverflowError:  # a Python-int operand beyond int64
        raise _overflow() from None
    return c


def _vsub(a, b):
    if not _int_arr(a, b):
        return a - b
    try:
        c = np.subtract(a, b)
        if (((a ^ b) & (a ^ c)) < 0).any():
            raise _overflow()
    except OverflowError:
        raise _overflow() from None
    return c


def _bound(x) -> int:
    """Largest absolute lane value, as an exact Python int."""
    if isinstance(x, np.ndarray):
        if not x.size:
            return 0
        return max(abs(int(x.min())), abs(int(x.max())))
    return abs(int(x))


def _vmul(a, b):
    if not _int_arr(a, b):
        return a * b
    try:
        c = np.multiply(a, b)
        # fast path: lane extrema prove no product can leave int64
        if _bound(a) * _bound(b) > 2 ** 63 - 1:
            # a wrapped product differs from the true one by k*2**64,
            # which no int64 divisor can fold back onto `a` — exact
            # divide-back check on every lane
            bb = np.asarray(b)
            ok = np.where(bb != 0,
                          np.floor_divide(c, np.where(bb == 0, 1, bb))
                          == a,
                          c == 0)
            if not np.all(ok):
                raise _overflow()
    except OverflowError:
        raise _overflow() from None
    return c


def _int_lanes(x):
    x = np.asarray(x)
    return x.astype(np.int64) if x.dtype.kind == "f" else x


def _vlt(a, b):
    return np.less(a, b).astype(np.int64) if _is_arr(a, b) else int(a < b)


def _vle(a, b):
    return (np.less_equal(a, b).astype(np.int64) if _is_arr(a, b)
            else int(a <= b))


def _vgt(a, b):
    return np.greater(a, b).astype(np.int64) if _is_arr(a, b) else int(a > b)


def _vge(a, b):
    return (np.greater_equal(a, b).astype(np.int64) if _is_arr(a, b)
            else int(a >= b))


def _veq(a, b):
    return np.equal(a, b).astype(np.int64) if _is_arr(a, b) else int(a == b)


def _vne(a, b):
    return (np.not_equal(a, b).astype(np.int64) if _is_arr(a, b)
            else int(a != b))


def _vand(a, b):
    if _is_arr(a, b):
        return ((np.asarray(a) != 0) & (np.asarray(b) != 0)).astype(np.int64)
    return int(bool(a) and bool(b))


def _vor(a, b):
    if _is_arr(a, b):
        return ((np.asarray(a) != 0) | (np.asarray(b) != 0)).astype(np.int64)
    return int(bool(a) or bool(b))


def _vxor(a, b):
    if _is_arr(a, b):
        return _int_lanes(a) ^ _int_lanes(b)
    return int(a) ^ int(b)


def _vmin(a, b):
    return np.minimum(a, b) if _is_arr(a, b) else min(a, b)


def _vmax(a, b):
    return np.maximum(a, b) if _is_arr(a, b) else max(a, b)


def _vdiv(a, b):
    if not _is_arr(a, b):
        return int(a) // int(b) if b else 0
    aa, bb = _int_lanes(a), _int_lanes(b)
    safe = np.where(bb == 0, 1, bb)
    return np.where(bb != 0, aa // safe, 0)


def _vmod(a, b):
    if not _is_arr(a, b):
        return int(a) % int(b) if b else 0
    aa, bb = _int_lanes(a), _int_lanes(b)
    safe = np.where(bb == 0, 1, bb)
    return np.where(bb != 0, aa % safe, 0)


def _vsel(c, t, f):
    if isinstance(c, np.ndarray):
        return np.where(c != 0, t, f)
    return t if c else f


def _vwhere(p, t, f):
    if isinstance(p, np.ndarray):
        return np.where(p, t, f)
    return t if p else f


def _band(p, c):
    if isinstance(c, np.ndarray):
        return p & (c != 0)
    return p & bool(c)


def _bnot(p, c):
    if isinstance(c, np.ndarray):
        return p & (c == 0)
    return p & (not c)


def _vload(arr, ix, hi):
    if isinstance(ix, np.ndarray):
        if ix.dtype.kind == "f":
            ix = ix.astype(np.int64)
        return arr[np.clip(ix, 0, hi)]
    a = int(ix)
    a = 0 if a < 0 else (hi if a > hi else a)
    return arr[a]


def _vstore(arr, ix, val, pred, hi, m2):
    """Masked local-array scatter for the committed epoch prefix.

    Applied *after* the driver's commit decided the cut, so lanes beyond
    ``m2`` (whose values may be stale) never land.  Out-of-bounds lanes
    are dropped (the scalar emitters' silent-skip store semantics), and
    duplicate destinations resolve last-writer-wins.
    """
    if isinstance(pred, np.ndarray):
        pred = pred[:m2]
    if isinstance(ix, np.ndarray):
        ix = ix[:m2]
    if isinstance(val, np.ndarray):
        val = val[:m2]
    ixa = np.asarray(ix)
    if ixa.dtype.kind == "f":
        ixa = ixa.astype(np.int64)
    ixa, valb, predb = np.broadcast_arrays(np.atleast_1d(ixa),
                                           np.atleast_1d(np.asarray(val)),
                                           np.atleast_1d(np.asarray(pred)))
    ok = predb & (ixa >= 0) & (ixa <= hi)
    if not ok.any():
        return
    eff = np.where(ok, ixa, -1)
    keep = last_writer_keep(eff)
    arr[eff[keep]] = valb[keep]


VECTOR_NS = {
    "_np": np, "_band": _band, "_bnot": _bnot, "_vsel": _vsel,
    "_vwhere": _vwhere, "_vload": _vload, "_vstore": _vstore,
    "_vadd": _vadd, "_vsub": _vsub, "_vmul": _vmul,
    "_vlt": _vlt, "_vle": _vle, "_vgt": _vgt, "_vge": _vge,
    "_veq": _veq, "_vne": _vne, "_vand": _vand, "_vor": _vor,
    "_vxor": _vxor, "_vmin": _vmin, "_vmax": _vmax,
    "_vdiv": _vdiv, "_vmod": _vmod,
}


# ---------------------------------------------------------------------------
# epoch drivers
# ---------------------------------------------------------------------------


class _VectorDriver:
    """Stream cursors + epoch planning/forwarding shared by both targets."""

    def __init__(self, loops: List[UniformLoop], streams: Streams,
                 memory: Dict[str, np.ndarray], arrays: List[str],
                 forward: bool = True):
        self.loops = loops
        self.arrays = arrays
        self.forward = forward
        self.ld_raw = {a: streams.ld_raw.get(a, []) for a in arrays}
        self.ld_pos = {a: streams.ld_pos.get(a, []) for a in arrays}
        self.st_addrs = {a: streams.st_addrs.get(a, []) for a in arrays}
        self.st_pos = {a: streams.st_pos.get(a, []) for a in arrays}
        self.np_ld = {a: np.asarray(streams.ld_clamped.get(a, []),
                                    dtype=np.int64) for a in arrays}
        self.np_st = {a: np.asarray(self.st_addrs[a], dtype=np.int64)
                      for a in arrays}
        self.hi = {a: len(memory[a]) - 1 for a in arrays}
        self.lp = {a: 0 for a in arrays}
        self.sp = {a: 0 for a in arrays}
        self.committed = 0
        self.poisoned = 0
        self.consumed = 0
        self.epochs = 0
        self.fwd_epochs = 0
        self.fwd_refusals = 0
        self.fwd_reason: Optional[str] = None

    # -- emitted-code interface ---------------------------------------------
    def plan(self, lid: int, remaining: int) -> int:
        """Window size in whole iterations for the next epoch."""
        ul = self.loops[lid]
        m = plan_iters(remaining, ul.k_loads, ul.k_stores)
        if m <= 0:
            raise CodegenError(tag(
                "V02-epoch-stalled",
                "vector epoch cannot hold a single iteration "
                "(per-iteration request count exceeds the batch bound)"))
        return m

    def gather(self, lid: int, m: int) -> Dict[str, np.ndarray]:
        """One bulk gather serving every array of the window."""
        ul = self.loops[lid]
        req: Dict[str, np.ndarray] = {}
        for a, k in ul.k_loads.items():
            if not k:
                continue
            lp = self.lp[a]
            idx = self.np_ld[a][lp:lp + m * k]
            if len(idx) < m * k:
                raise CodegenError(tag("V04-stream-underrun",
                                       f"load stream underrun @{a}"))
            req[a] = idx
        return self._gather_all(req)

    def commit(self, lid: int, m: int, body, ld0: Dict[str, np.ndarray]
               ) -> Tuple[int, list]:
        """Evaluate the epoch body, forward or cut, commit the prefix.

        Returns ``(m2, locs)``: how many iterations retired and the
        deferred local-array store lanes of the body evaluation that
        produced the committed values (the emitted code applies them for
        exactly the ``m2`` prefix).
        """
        # fault site: the driver dies at an epoch commit.  Raising here
        # is containment-safe by construction — every prior epoch went
        # to the private working copy / device table, and the caller's
        # memory is only written after the whole run succeeds.
        faults.inject("codegen.vector.epoch")
        self.epochs += 1
        ul = self.loops[lid]
        stores, locs = body(ld0)
        flat = self._flatten(ul, m, stores)

        m2 = m
        for a, (_, pflat) in flat.items():
            m2 = min(m2, self._cut(ul, m, a, pflat))
        if m2 == m:
            # E_0 fast path: no committed store feeds a later in-window
            # load, the whole window is exact as evaluated
            self._commit_window(ul, m, flat, {})
            return m, locs

        fwd = None
        if self.forward:
            fwd = self._try_forward(ul, m, body, ld0, flat, locs)
            if fwd is None:
                self.fwd_refusals += 1
        elif self.fwd_reason is None:
            self.fwd_reason = tag("F01-forward-refused",
                                  "forwarding disabled (forward=False)")

        if fwd is None:
            # sound fallback: cut at the first committed RAW hazard
            if m2 == 0:
                extra = (f" — forwarding refused: {self.fwd_reason}"
                         if self.fwd_reason else "")
                raise CodegenError(tag(
                    "V02-epoch-stalled",
                    "vector epoch stalled: a load aliases a committed "
                    "store of the same iteration (un-vectorisable RAW)"
                    + extra))
            self._commit_window(ul, m2, flat, {})
            return m2, locs

        flat_f, locs_f, deltas_f, m2f = fwd
        if m2f == 0:
            raise CodegenError(tag(
                "V02-epoch-stalled",
                "vector epoch stalled: a load aliases a committed store "
                "of the same iteration (un-vectorisable RAW on a "
                "non-forwardable array)"))
        self.fwd_epochs += 1
        self._commit_window(ul, m2f, flat_f, deltas_f)
        return m2f, locs_f

    # -- epoch internals ----------------------------------------------------
    def _flatten(self, ul: UniformLoop, m: int, stores) -> Dict[str, tuple]:
        """Slot lanes -> flat iteration-major (values, poison) per array."""
        flat: Dict[str, tuple] = {}
        for a, (vals, pois) in stores.items():
            s = ul.k_stores[a]
            vflat = np.column_stack(
                [np.broadcast_to(np.asarray(v), (m,)) for v in vals]
            ).reshape(-1) if s else np.empty(0, np.int64)
            pflat = np.column_stack(
                [np.broadcast_to(np.asarray(p, dtype=bool), (m,))
                 for p in pois]).reshape(-1) if s else np.empty(0, bool)
            flat[a] = (vflat, pflat)
        return flat

    def _cut(self, ul: UniformLoop, m: int, a: str, pflat) -> int:
        """First committed-RAW violation for one array, window-relative."""
        return first_violation(
            m, ul.k_loads.get(a, 0), ul.k_stores[a],
            self.ld_raw[a], self.ld_pos[a],
            self.st_addrs[a], self.st_pos[a],
            pflat, self.lp[a], self.sp[a])

    def _refuse(self, reason: str) -> None:
        self.fwd_reason = tag("F01-forward-refused", reason)
        return None

    def _try_forward(self, ul: UniformLoop, m: int, body, ld0, flat0,
                     locs0):
        """Segmented-scan RAW forwarding fixpoint for one epoch.

        Returns ``(flat, locs, deltas, m2)`` from the converged body
        evaluation — ``deltas`` maps each forwarded array to its
        per-store delta lanes for the reduceat commit combine, ``m2`` is
        the cut implied by the *non-forwardable* arrays under the final
        poison flags (forwarded arrays never cut) — or ``None`` with
        ``self.fwd_reason`` set when forwarding is refused; the caller
        then falls back to the plain :func:`first_violation` cut, which
        is sound regardless.
        """
        chains = {a: c for a, c in ul.fwd_chains.items() if a in flat0}
        hazard = [a for a, (_, pflat) in flat0.items()
                  if self._cut(ul, m, a, pflat) < m]
        if not any(a in chains for a in hazard):
            a = hazard[0]
            why = ul.fwd_reasons.get(a, "no associative store-update chain")
            return self._refuse(f"@{a}: {why}")

        # dynamic legality per forwarded array, checked once per window
        # (addresses and stream positions are epoch-invariant): these
        # checks carry the telescoping argument — see epochs.py
        win: Dict[str, tuple] = {}
        for a, c in sorted(chains.items()):
            if not self._int_ok(a):
                return self._refuse(
                    f"@{a}: non-integer dtype (delta telescoping is not "
                    f"bit-exact)")
            k = ul.k_loads[a]
            lp, sp = self.lp[a], self.sp[a]
            if len(self.st_addrs[a]) < sp + m:
                return self._refuse(f"@{a}: store stream underrun inside "
                                    f"the window")
            lraw = np.asarray(self.ld_raw[a][lp:lp + m * k], dtype=np.int64)
            lpos = np.asarray(self.ld_pos[a][lp:lp + m * k], dtype=np.int64)
            sraw = self.np_st[a][sp:sp + m]
            spos = np.asarray(self.st_pos[a][sp:sp + m], dtype=np.int64)
            if not np.array_equal(sraw, lraw[c::k]):
                return self._refuse(
                    f"@{a}: store address differs from its chain load "
                    f"(not an in-place update)")
            if not (lpos[c::k] < spos).all():
                return self._refuse(
                    f"@{a}: chain load does not precede the store in the "
                    f"request stream")
            win[a] = (k, c, lraw, lpos, sraw, spos)

        ld_cur = dict(ld0)
        flat_cur, locs_cur = flat0, locs0
        deltas_cur: Dict[str, np.ndarray] = {}
        for _ in range(MAX_FWD_PASSES):
            new_ld = dict(ld0)
            changed = False
            for a, (k, c, lraw, lpos, sraw, spos) in win.items():
                vflat, pflat = flat_cur[a]
                chain = np.asarray(ld_cur[a][c::k]).astype(np.int64)
                v64 = self._stored_value(a, vflat)
                d = np.subtract(v64, chain)
                if (((v64 ^ chain) & (v64 ^ d)) < 0).any():
                    return self._refuse(f"@{a}: store delta overflows "
                                        f"int64")
                contrib = np.where(pflat, 0, d)
                addrs = np.concatenate([lraw, sraw])
                pos = np.concatenate([lpos, spos])
                cont = np.concatenate(
                    [np.zeros(m * k, np.int64), contrib])
                try:
                    sums = segment_forward(addrs, pos, cont)[:m * k]
                except OverflowError:
                    return self._refuse(f"@{a}: segmented-scan partial "
                                        f"sum overflows int64")
                g64 = np.asarray(ld0[a]).astype(np.int64)
                est = np.add(g64, sums)
                if (((g64 ^ est) & (sums ^ est)) < 0).any():
                    return self._refuse(f"@{a}: forwarded load estimate "
                                        f"overflows int64")
                est = self._lane_value(a, est)
                deltas_cur[a] = d
                new_ld[a] = est
                if not np.array_equal(est, np.asarray(ld_cur[a])):
                    changed = True
            if not changed:
                break  # flat_cur/deltas_cur match the fixpoint estimates
            ld_cur = new_ld
            try:
                stores, locs_cur = body(ld_cur)
            except CodegenError as e:
                # a lane overflow under (possibly garbage-beyond-cut)
                # forwarded estimates: refuse, the cut path re-evaluates
                # each shorter window from exact gathered values
                return self._refuse(f"body re-evaluation failed under "
                                    f"forwarded estimates: {e}")
            flat_cur = self._flatten(ul, m, stores)
        else:
            return self._refuse(
                f"no fixpoint after {MAX_FWD_PASSES} forwarding passes "
                f"(commit mask oscillates)")

        m2 = m
        for a, (_, pflat) in flat_cur.items():
            if a in chains:
                continue  # forwarded loads are never stale
            m2 = min(m2, self._cut(ul, m, a, pflat))
        return flat_cur, locs_cur, deltas_cur, m2

    def _commit_window(self, ul: UniformLoop, m2: int, flat, deltas
                       ) -> None:
        """Commit the ``m2``-iteration prefix through one bulk scatter."""
        evts = []
        for a, (vflat, pflat) in flat.items():
            n = m2 * ul.k_stores[a]
            sp = self.sp[a]
            addrs = self.np_st[a][sp:sp + n]
            if len(addrs) < n:
                raise CodegenError(tag("V04-stream-underrun",
                                       f"store stream underrun @{a}"))
            vals, pois = vflat[:n], pflat[:n]
            ok = ~pois
            oob = ok & ((addrs < 0) | (addrs > self.hi[a]))
            if oob.any():
                i = int(np.argmax(oob))
                raise CodegenError(
                    f"non-poisoned store out of bounds: {a}[{int(addrs[i])}]")
            d = deltas.get(a)
            evts.append((a, addrs, vals, pois,
                         None if d is None else d[:n]))
        self._scatter_all(evts)
        for a, (vflat, pflat) in flat.items():
            n = m2 * ul.k_stores[a]
            self.sp[a] += n
            nc = int((~pflat[:n]).sum())
            self.committed += nc
            self.poisoned += n - nc
        for a, k in ul.k_loads.items():
            if k:
                self.lp[a] += m2 * k
                self.consumed += m2 * k

    # -- target hooks --------------------------------------------------------
    def _int_ok(self, a: str) -> bool:
        """Whether forwarding's integer telescoping is exact for ``a``."""
        return True

    def _stored_value(self, a: str, vflat) -> np.ndarray:
        """Store lanes as the int64 value that would land in memory."""
        return np.asarray(vflat).astype(np.int64)

    def _lane_value(self, a: str, est64: np.ndarray) -> np.ndarray:
        """Forwarded int64 estimates in the dtype the body expects."""
        return est64

    def verify(self) -> None:
        """Integrity barrier before memory write-back (no-op unless a
        fault plan is armed and the driver keeps an independent
        replica)."""

    def stats(self) -> Dict[str, Any]:
        """State-machine-compatible counters plus epoch/forwarding ones."""
        d = {
            "stores_committed": self.committed,
            "stores_poisoned": self.poisoned,
            "loads_consumed": self.consumed,
            "ld_leftover": sum(len(self.ld_raw[a]) - self.lp[a]
                               for a in self.arrays),
            "st_leftover": sum(len(self.st_addrs[a]) - self.sp[a]
                               for a in self.arrays),
            "epochs": self.epochs,
            "fwd_epochs": self.fwd_epochs,
            "fwd_refusals": self.fwd_refusals,
        }
        if self.fwd_reason is not None:
            d["fwd_refusal_reason"] = self.fwd_reason
        return d


class _NumpyVectorDriver(_VectorDriver):
    """Epochs against private numpy working copies (any dtype)."""

    def __init__(self, loops, streams, memory, arrays, forward=True):
        super().__init__(loops, streams, memory, arrays, forward)
        self.work = {a: memory[a].copy() for a in arrays}

    def _gather_all(self, req: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """Bulk gather: index each private working copy directly."""
        return {a: self.work[a][idx] for a, idx in req.items()}

    def _scatter_all(self, evts) -> None:
        """Bulk scatter.

        Plain arrays resolve write-after-write last-writer-wins and
        store final values; forwarded arrays collapse each same-address
        run to one combined delta (:func:`repro.codegen.epochs
        .combine_runs`, the ``np.add.reduceat`` path) and add it — the
        fancy-indexed assignment narrows to the array dtype with
        two's-complement wrap, which matches the final stored value
        because the deltas telescope modulo the dtype width.
        """
        for a, addrs, vals, pois, deltas in evts:
            if deltas is None:
                eff = np.where(pois, -1, addrs)
                keep = last_writer_keep(eff)
                if keep.any():
                    self.work[a][eff[keep]] = vals[keep]
                continue
            ok = ~pois
            if not ok.any():
                continue
            uniq, tot = combine_runs(addrs[ok], deltas[ok])
            w = self.work[a]
            w[uniq] = (w[uniq].astype(np.int64, copy=False) + tot
                       ).astype(w.dtype, copy=False)

    def _int_ok(self, a: str) -> bool:
        return self.work[a].dtype.kind in "iu"

    def _stored_value(self, a: str, vflat) -> np.ndarray:
        # the value that lands in memory is the lane narrowed to the
        # array dtype (the scatter assignment wraps); widen that back so
        # deltas telescope in the dtype's modular ring
        w = self.work[a]
        return np.asarray(vflat).astype(w.dtype, copy=False) \
                                .astype(np.int64, copy=False)

    def _lane_value(self, a: str, est64: np.ndarray) -> np.ndarray:
        # what a fresh gather of the committed value would return
        return est64.astype(self.work[a].dtype, copy=False)

    def finalize(self, memory: Dict[str, np.ndarray]) -> None:
        """Write the private copies back to the caller's arrays."""
        for a in self.arrays:
            memory[a][:] = self.work[a]


class _TorchVectorDriver(_VectorDriver):
    """Epochs against one fused device int32 table (CUDA kernels).

    Every decoupled array occupies a contiguous row range of a single
    ``(n_total, 1)`` ``torch.int32`` table at a per-array base offset, so
    one ``spec_gather`` serves every load of an epoch and one
    ``spec_scatter_add`` serves every store — kernel-call counts are per
    *epoch*, not per array.  Both go by the staged route through one
    :class:`~repro_torch.kernels.staging.Ring`: no per-epoch copy and no
    per-epoch device tensor.  An exact int64 host mirror of the table
    supplies every add-delta, so the device never computes one.
    """

    def __init__(self, loops, streams, memory, arrays, device,
                 forward=True):
        super().__init__(loops, streams, memory, arrays, forward)
        self.base: Dict[str, int] = {}
        off = 0
        parts = []
        for a in arrays:
            self.base[a] = off
            off += len(memory[a])
            parts.append(memory[a].astype(np.int64))
        self.n_total = off
        self.mirror = (np.concatenate(parts) if parts
                       else np.zeros(0, np.int64))
        self.table = torch.from_numpy(
            self.mirror.astype(np.int32).reshape(-1, 1)).to(device)
        self.ring = Ring(device)
        self.gather_calls = 0
        self.scatter_calls = 0

    def _gather_all(self, req: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """One fused ``spec_gather`` covering every array of the epoch."""
        if not req:
            return {}
        names = sorted(req)
        n = sum(len(req[a]) for a in names)
        slot = self.ring.acquire(n)
        gidx = slot.idx[:n]
        o = 0
        for a in names:
            k = len(req[a])
            np.add(req[a], self.base[a], out=gidx[o:o + k],
                   casting="unsafe")
            o += k
        # the host mirror is exact by induction — a gather that disagrees
        # with it returned corrupted rows; catch it before the CU computes
        # (and later commits) anything from it.  Read before the gather:
        # an armed allpoison fault overwrites the slot's indices.
        exp = self.mirror[gidx] if faults.corrupting() else None
        flat = spec_gather_staged(self.table, slot, n).astype(np.int64)
        self.gather_calls += 1
        if exp is not None and not np.array_equal(flat, exp):
            raise FaultDetected(
                "codegen.vector.gather",
                "gather verify failed: device rows differ from host mirror")
        out: Dict[str, np.ndarray] = {}
        o = 0
        for a in names:
            k = len(req[a])
            out[a] = flat[o:o + k]
            o += k
        return out

    def _scatter_all(self, evts) -> None:
        """One fused WAW/RAW-resolved ``spec_scatter_add`` per epoch.

        Plain arrays contribute last-writer rows whose delta against the
        host mirror re-wraps to the final value in two's-complement (the
        state-machine driver's delta trick); forwarded arrays contribute
        one combined-delta row per same-address run
        (:func:`repro_torch.codegen.epochs.combine_runs`).  All rows land
        in a single kernel call against the fused table.
        """
        rows_i: List[np.ndarray] = []
        rows_d: List[np.ndarray] = []
        post = []  # mirror updates applied only after the device commit
        for a, addrs, vals, pois, deltas in evts:
            ok = ~pois
            if not ok.any():
                continue  # every slot poisons: nothing to commit
            if deltas is None:
                v64 = np.asarray(vals).astype(np.int64)
                lo, hi = int(v64[ok].min()), int(v64[ok].max())
                if lo < _I32_MIN or hi > _I32_MAX:
                    raise CodegenError(tag(
                        "V03-lane-overflow",
                        f"torch target: store value outside int32 range "
                        f"@{a}"))
                eff = np.where(pois, -1, addrs)
                keep = last_writer_keep(eff)
                if not keep.any():
                    continue
                gi = self.base[a] + eff[keep]
                cur = self.mirror[gi]
                rows_i.append(gi)
                # int64 -> int32 cast wraps; the scatter-add re-wraps,
                # so the committed value is exact in two's-complement
                rows_d.append((v64[keep] - cur).astype(np.int32))
                post.append(("set", gi, v64[keep]))
            else:
                uniq, tot = combine_runs(addrs[ok], deltas[ok])
                gi = self.base[a] + uniq
                fin = self.mirror[gi] + tot
                if (int(fin.min()) < _I32_MIN
                        or int(fin.max()) > _I32_MAX):
                    raise CodegenError(tag(
                        "V03-lane-overflow",
                        f"torch target: store value outside int32 range "
                        f"@{a}"))
                rows_i.append(gi)
                rows_d.append(tot.astype(np.int32))
                post.append(("add", gi, tot))
        if not rows_i:
            return
        n = sum(len(r) for r in rows_i)
        slot = self.ring.acquire(n)
        np.concatenate(rows_i, out=slot.idx[:n], casting="unsafe")
        np.concatenate(rows_d, out=slot.val[:n], casting="unsafe")
        self.table = spec_scatter_add_staged(self.table, slot, n)
        self.scatter_calls += 1
        for kind, gi, v in post:
            if kind == "set":
                self.mirror[gi] = v
            else:
                self.mirror[gi] += v

    def verify(self) -> None:
        """Compare the fused device table against the host mirror."""
        if not faults.corrupting():
            return
        tab = self.table[:, 0].cpu().numpy().astype(np.int64)
        if not np.array_equal(tab, self.mirror):
            raise FaultDetected(
                "codegen.vector.commit",
                "fused device table diverged from host mirror (a scatter "
                "dropped or corrupted committed stores)")

    def finalize(self, memory: Dict[str, np.ndarray]) -> None:
        """Split the fused table back into the caller's arrays."""
        tab = self.table[:, 0].cpu().numpy()
        for a in self.arrays:
            o = self.base[a]
            memory[a][:] = tab[o:o + len(memory[a])].astype(memory[a].dtype)

    def stats(self) -> Dict[str, Any]:
        """Driver counters plus per-epoch kernel-call counts."""
        d = super().stats()
        d["gather_calls"] = self.gather_calls
        d["scatter_calls"] = self.scatter_calls
        return d


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_vector(compiled, memory: Dict[str, np.ndarray],
               params: Dict[str, Any], streams: Streams, analysis,
               target: str, *, device: Optional[torch.device] = None,
               max_steps: int = 2_000_000,
               forward: bool = True) -> Dict[str, Any]:
    """Execute the vectorised CU; mutates ``memory`` only on success.

    ``target="torch"`` runs the epochs against the fused device table on
    ``device``; ``"numpy"`` against private numpy copies.
    ``forward=False`` disables segmented-scan RAW forwarding so every
    committed same-address hazard cuts the epoch (the pre-forwarding
    behaviour — useful for A/B epoch-count comparisons).

    Raises :class:`CodegenError` (memory untouched) when the CU is not
    iteration-uniform or a dynamic hazard stalls an epoch — the caller
    then retries through the per-element state machine.
    """
    from .emit import compile_mode
    cu_make = compile_mode(compiled.cu, "cu-vector")
    if cu_make is None:
        loops, why = uniform_loops(compiled.cu)
        # ``why`` is already V01-tagged by uniform_loops; re-tag so the
        # rule ID leads the composed message exactly once.
        raise CodegenError(tag(
            "V01-cu-not-uniform",
            f"CU not iteration-uniform: "
            f"{detail_of(why) or 'vector emission refused'}"))
    loops, _ = uniform_loops(compiled.cu)

    dec = sorted(set(streams.arrays) | set(analysis.decoupled))
    if target == "torch":
        from .torch_backend import _check_i32
        for a in dec:
            _check_i32(a, memory[a])
        drv: _VectorDriver = _TorchVectorDriver(loops, streams, memory, dec,
                                                device, forward=forward)
    else:
        drv = _NumpyVectorDriver(loops, streams, memory, dec,
                                 forward=forward)

    stats = cu_make(memory, dict(params), drv, max_steps)
    # every epoch committed and the integrity barrier passed — only now
    # touch the caller's memory (verify() must precede the first write,
    # or a detected fault would leave a partial commit behind)
    drv.verify()
    for a, mirror in stats.pop("locals", {}).items():
        memory[a][:] = mirror
    drv.finalize(memory)
    return stats
