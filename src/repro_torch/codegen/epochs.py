"""Shared epoch scheduler: disambiguation planning for generated kernels.

Both executable targets replay the CU against the ahead-of-time AGU
streams in *epochs* — contiguous stretches of requests that can be served
by one bulk memory operation per direction (gather the loads, then commit
the stores).  An epoch is legal exactly when no load inside it needs the
value of a store that is also inside it (the LSQ's dynamic disambiguation,
restated on the host over the precomputed address streams).  This module
is the single place that rule lives, so the numpy and jax targets — and
the per-element state machine and the vectorised path — plan identically:

* :func:`gather_limit` — the *pessimistic*, per-element fence used by the
  state-machine jax driver (PR 4 behaviour, lifted out of
  ``_ArrayDriver.refill``): stop before the first load whose raw address
  aliases any older unflushed store request, poisoned or not (at plan
  time the state machine has not replayed the CU, so it cannot know which
  slots will poison).

* :func:`plan_iters` / :func:`first_violation` — the *optimistic*,
  iteration-granular planner used by the vectorised CU.  After
  if-conversion the whole epoch is computed before anything commits, so
  poison is data: a poisoned store commits nothing and therefore cannot
  feed a later load.  The vectoriser gathers a full ``plan_iters`` window,
  evaluates the straight-line body, and only then cuts the epoch at the
  first *committed* (non-poisoned) store that an in-window younger load
  aliases.  Iterations before the cut used only pre-epoch memory and
  older committed values they could not observe — their loads, predicates
  and poison flags are exact, which is what makes the optimistic cut
  sound (see the inline proof sketch on :func:`first_violation`).

* :func:`plan_segments` / :func:`segment_forward` / :func:`combine_runs`
  — the *segmented-scan forwarding* layer (see ``docs/epochs.md``).  When
  the committed stores of an epoch form same-address runs that feed later
  in-window loads only through an associative update (``value = chain
  load + delta``, the ``spec_scatter_add`` shape), the epoch need not be
  cut at all: the per-store deltas are sorted into address segments and
  an exclusive segmented prefix sum forwards the combined value of every
  older committed store to each in-window load.  The vector drivers
  (:mod:`repro.codegen.vector`) iterate this to a fixpoint; soundness of
  the fixpoint is argued on :func:`segment_forward`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

#: largest single gather/scatter batch (bounds jit shape variety and the
#: interpret-mode grid length); epochs longer than this are split.
MAX_BATCH = 512

#: int32 device-table value range (the jax targets' integer subset)
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1

#: bound on forwarding fixpoint body re-evaluations per epoch.  Two
#: passes suffice when the per-store delta does not depend on the
#: forwarded loads (hist: ``delta = w[i]``) and three when it does only
#: through already-exact values (spmv); a window that still has not
#: converged (e.g. a saturating guard flipping commit masks back and
#: forth) is refused and the epoch falls back to the sound
#: :func:`first_violation` cut.
MAX_FWD_PASSES = 6

#: magnitude bound on any segmented-scan partial sum.  Cross-segment
#: int64 wraparound cancels exactly in :func:`segment_forward`'s base
#: subtraction (two's complement), but a *within-segment* partial sum
#: beyond int64 would corrupt the forwarded estimate silently; partial
#: sums are therefore shadowed in float64 (absolute error < 2**30 for
#: MAX_BATCH int64 terms, negligible against this bound) and the scan
#: refuses past it.
FWD_SUM_BOUND = float(2 ** 61)


def gather_limit(ld_raw: Sequence[int], ld_pos: Sequence[int],
                 st_addrs: Sequence[int], st_pos: Sequence[int],
                 lp: int, fp: int, max_batch: int = MAX_BATCH) -> int:
    """Pessimistic per-element fence: first un-gatherable load index.

    Loads ``[lp, k)`` for the returned ``k`` may be gathered now: none of
    them aliases a store request that is older in the combined per-array
    stream and not yet flushed (``>= fp``).  Poison status is unknown at
    this point, so every unflushed store blocks (the state-machine jax
    driver replays the CU element by element and flushes between epochs).
    """
    pend = set()
    j = fp
    k = lp
    n_st = len(st_addrs)
    n_ld = len(ld_raw)
    end = lp + max_batch
    while k < n_ld and k < end:
        p = ld_pos[k]
        while j < n_st and st_pos[j] < p:
            pend.add(st_addrs[j])
            j += 1
        if ld_raw[k] in pend:
            break
        k += 1
    return k


def plan_iters(remaining: int, k_loads: Dict[str, int],
               k_stores: Dict[str, int],
               max_batch: int = MAX_BATCH) -> int:
    """Optimistic window size in whole iterations, capped per array.

    ``k_loads``/``k_stores`` are the per-iteration request counts of the
    (iteration-uniform) loop; the window keeps every array's flat batch
    within ``max_batch`` so one gather and one scatter per array serve the
    whole epoch.  Returns 0 when even a single iteration cannot fit.

    A loop with *no* requests at all (a pure-compute init loop can pass
    the uniformity check) is still capped at ``max_batch`` iterations per
    epoch, so lane allocation stays bounded regardless of the trip count.
    """
    m = min(remaining, max_batch)
    for k in k_loads.values():
        if k:
            m = min(m, max_batch // k)
    for s in k_stores.values():
        if s:
            m = min(m, max_batch // s)
    return max(m, 0)


def first_violation(m: int, k: int, s: int,
                    ld_raw: Sequence[int], ld_pos: Sequence[int],
                    st_addrs: Sequence[int], st_pos: Sequence[int],
                    poison, lp: int, sp: int) -> int:
    """First window-relative iteration whose gathered load is stale.

    The vectorised epoch gathered loads ``[lp, lp + m*k)`` against
    pre-epoch memory and computed store values/poison flags for
    iterations ``[0, m)``.  A load is *stale* iff an older in-window
    store to the same raw address commits (is not poisoned).  Returns the
    iteration of the first stale load (the epoch must be cut there), or
    ``m`` when the whole window is clean.

    Soundness of using the optimistically computed ``poison`` flags: let
    ``v*`` be the true first stale-load iteration across all arrays.
    Every load in iterations ``< v*`` read exact values, so every store
    value and poison flag in iterations ``< v*`` is exact.  A store at
    iteration ``>= v*`` can only produce a *later* violation (its
    younger aliasing load is younger still), so the minimum over arrays
    of this scan is exactly ``v*`` — garbage beyond the cut can shift
    later violations around but never create an earlier one.

    ``poison`` is indexed window-relative (flat, iteration-major, length
    ``m*s``).
    """
    if k == 0 or s == 0:
        return m
    committed = set()
    f = lp
    g = sp
    f_end = lp + m * k
    # a short store stream (AGU under-issue) is caught as an explicit
    # underrun when the committed prefix is sliced — the scan itself
    # must not index past the real stream
    g_end = min(sp + m * s, len(st_addrs))
    while f < f_end:
        p = ld_pos[f]
        while g < g_end and st_pos[g] < p:
            if not poison[g - sp]:
                committed.add(st_addrs[g])
            g += 1
        if ld_raw[f] in committed:
            return (f - lp) // k
        f += 1
    return m


def plan_segments(addrs: "np.ndarray", pos: "np.ndarray"
                  ) -> Tuple["np.ndarray", "np.ndarray"]:
    """Sort request events into same-address segments, oldest first.

    ``addrs``/``pos`` are parallel int arrays of one epoch's in-window
    events for a single decoupled array (loads and stores mixed; ``pos``
    is the per-array combined stream position, so it orders events the
    way the sequential machine would serve them).  Returns ``(order,
    starts)``: ``order`` permutes the events into ``(addr, pos)``
    lexicographic order and ``starts`` flags the first event of each
    address segment within that order.  All forwarding arithmetic
    (:func:`segment_forward`, :func:`combine_runs`) keys off this one
    segmentation so the numpy and jax drivers combine runs identically.
    """
    order = np.lexsort((pos, addrs))
    a_sorted = addrs[order]
    starts = np.ones(len(a_sorted), dtype=bool)
    if len(a_sorted) > 1:
        starts[1:] = a_sorted[1:] != a_sorted[:-1]
    return order, starts


def segment_forward(addrs: "np.ndarray", pos: "np.ndarray",
                    contrib: "np.ndarray") -> "np.ndarray":
    """Exclusive per-address prefix sums of ``contrib`` in stream order.

    The segmented scan at the heart of RAW forwarding: event ``e``
    receives the sum of ``contrib`` over all events at the **same
    address** with **smaller stream position**.  Load events pass
    ``contrib = 0`` (pure queries); committed stores pass their delta
    (``store value - chain load value``), so a load's result is exactly
    the total committed increment applied to its address by older
    in-window stores — adding it to the pre-epoch gathered value yields
    the value the sequential machine would have served.

    Soundness (with the dynamic legality checks made by the driver —
    every committed store's address equals its iteration's chain-load
    address, the chain load precedes the store in the per-array stream,
    and the array is integer-typed so increments compose exactly):
    within one address segment the committed deltas telescope,
    ``mem_after(g) = mem_before(g) + delta_g``, so the exclusive prefix
    sum at a load event reconstructs the exact memory value at that
    point of the stream.  The drivers iterate body evaluation and this
    scan to a fixpoint; at the fixpoint the load estimates are
    self-consistent, and because every store value depends only on
    same-iteration loads with *smaller* stream position (per-array
    positions are iteration-monotone), the dependence is strictly
    triangular in stream order — the fixpoint is unique and equals the
    sequential semantics.  See ``docs/epochs.md`` for the full argument,
    including why a non-forwardable array's cut keeps the mixed-array
    prefix exact.

    Cross-segment int64 wraparound cancels in the base subtraction
    (two's complement); a genuine within-segment overflow is caught by a
    float64 shadow of the running sum and raises ``OverflowError`` so
    the caller refuses forwarding instead of committing garbage.
    """
    n = len(addrs)
    out = np.zeros(n, dtype=np.int64)
    if n == 0:
        return out
    order, starts = plan_segments(addrs, pos)
    c_sorted = contrib[order]
    shadow = np.cumsum(c_sorted.astype(np.float64))
    if np.abs(shadow).max() >= FWD_SUM_BOUND:
        raise OverflowError("segmented-scan partial sum beyond int64")
    csum = np.cumsum(c_sorted)
    excl = csum - c_sorted
    seg_id = np.cumsum(starts) - 1
    base = excl[np.flatnonzero(starts)][seg_id]
    out[order] = excl - base
    return out


def combine_runs(addrs: "np.ndarray", deltas: "np.ndarray"
                 ) -> Tuple["np.ndarray", "np.ndarray"]:
    """Total committed delta per distinct address (one row per run).

    The commit-side counterpart of :func:`segment_forward`: given the
    committed stores of an epoch prefix as ``(addr, delta)`` pairs, the
    final memory value at each address is ``pre-epoch value + total
    delta`` (the same telescoping that makes forwarding exact), so one
    ``np.add.reduceat`` over the sorted runs collapses an arbitrarily
    long same-address run into a single scatter row.  Returns
    ``(unique_addrs, totals)`` with ``unique_addrs`` ascending.
    """
    if len(addrs) == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    order = np.argsort(addrs, kind="stable")
    a_sorted = addrs[order]
    d_sorted = deltas[order]
    starts = np.ones(len(a_sorted), dtype=bool)
    if len(a_sorted) > 1:
        starts[1:] = a_sorted[1:] != a_sorted[:-1]
    idx = np.flatnonzero(starts)
    totals = np.add.reduceat(d_sorted, idx)
    return a_sorted[idx], totals


def last_writer_keep(eff_idx) -> "List[bool]":
    """Mask selecting, per address, the *last* non-negative occurrence.

    ``eff_idx`` is a numpy int array of destination indices with ``-1``
    marking poisoned slots.  Committing only the selected slots with
    their final values is order-independent, which is what lets the
    vectorised path resolve write-after-write collisions inside one
    scatter instead of splitting the batch (the per-element driver's
    ``seen``-set split) — same committed memory, one kernel call.
    """
    import numpy as np
    n = len(eff_idx)
    keep = np.zeros(n, dtype=bool)
    if n == 0:
        return keep
    rev = eff_idx[::-1]
    _, first = np.unique(rev, return_index=True)
    keep[n - 1 - first] = True
    keep &= eff_idx >= 0
    return keep
