"""Event scheduler: ``(ready_cycle, unit)`` wakeups.

Time advances by jumping straight to the earliest pending wakeup instead of
ticking through idle cycles.  Correctness rests on one invariant, shared
with the cycle-stepped reference model:

* a **spurious** wakeup (running a unit in a cycle where it makes no
  progress) is always harmless — it is exactly what the reference model
  does every cycle, and a no-op run changes no state;
* a **missed** wakeup (failing to run a unit in a cycle where the reference
  model would have made progress) is the only way to diverge.

So every state mutation that can unblock a unit must schedule a wakeup for
it (see :mod:`repro_torch.core.sim.fifo` for the FIFO-edge wiring), and wakeups
may be scheduled generously.

Units carry a ``wake`` attribute (their earliest pending wakeup cycle, or
``INF``).  ``schedule`` only ever *lowers* ``wake``; a unit's ``wake`` is
reset to ``INF`` by the machine loop when the unit runs.

Implementation note: this began life as a heap of ``(ready_cycle, seq,
unit)`` entries with lazy invalidation, but a DAE machine has only a
handful of units (two slice processes plus one LSQ per decoupled array —
rarely more than four in the paper's workloads), so ``next_cycle`` is a
linear min-scan over the registered units: cheaper than heap maintenance
at these sizes, with the same scheduler interface.  Hot paths (the FIFO
edges) update ``unit.wake`` directly — the inlined form of ``schedule``.

Batch windows (the quiescent-stretch theorem)
---------------------------------------------
``next_two`` exposes the earliest and second-earliest pending wakeups.
When the earliest belongs to a single slice process P and every other
unit's wake is ≥ T (the second-earliest), the machine may grant P the
half-open **window** [now, T) and let it advance through all of those
cycles in one step.  This discharges the proof obligations the per-cycle
interleaving normally carries:

* *No missed wakeup of another unit* — a unit's ``wake`` is a sound lower
  bound on the next cycle it can make progress **absent external
  mutation** (that is the missed-wakeup invariant above: every mutation
  that could unblock it lowers ``wake``).  Since only P runs inside the
  window, no FIFO edge, LSQ retirement, or poison event can fire before T
  unless P itself causes it.
* *P's own mutations* — private ops (compute, slice-local memory,
  registers) touch no shared state; every FIFO push/pop P performs lowers
  exactly one other unit's ``wake`` monotonically, and P must immediately
  **clamp its window end to that new wake**, restoring the premise for
  the remaining cycles.  A pop edge lowers the LSQ's wake to the current
  cycle (the DU phase runs after the slice phases), which closes the
  window at that cycle — the machine then runs the DU phase of the same
  cycle in the usual order.
* *Phase order* — the grant requires every other unit's wake ≥ T, so no
  AGU→CU→DU ordering within [now, T) is observable: the reference model
  would run those phases as no-ops.

A window is therefore *permission*, not obligation: a process that
ignores ``window_end`` (e.g. the interpreted fallback mid-park) simply
yields every cycle, which is the reference behaviour.

Steady-state pipeline windows (the multi-unit extension)
--------------------------------------------------------
The quiescent theorem above grants a window to a *single slice process*.
``MachineConfig(pipeline_window=True)`` extends the grant to the other
two shapes the wakeup scan can prove, which together cover the
steady-state pipeline pattern of load-dense kernels (AGU pushing one
request, CU consuming one value, LSQ retiring one load per cycle with
``mem_lat`` loads in flight — the pattern slice windows alone could never
cover):

* **Sole-runnable LSQ** — symmetric to the slice case: when the earliest
  wake belongs to an LSQ and every other unit's wake is ≥ T, the LSQ is
  granted ``[now, T)`` and advances through it with the compiled run-tick
  (:meth:`repro_torch.core.sim.units.LSQ.tick_run`).  The proof obligations
  mirror the slice grant: no other unit can run before T absent the
  LSQ's own mutations, and every FIFO edge the LSQ performs lowers
  exactly one slice's ``wake`` monotonically — the run re-checks both
  slice wakes before entering each further cycle, which is the clamp.
  Inside the run, stretches whose per-cycle effect is provably a single
  retirement (all in-flight loads issued, no store in flight, no request
  or store-value arrival before the horizon) or a single in-order commit
  (every queued store valued) collapse into one arrival-sorted splice
  (:meth:`repro_torch.core.sim.fifo.Fifo.push_run`) instead of one Python
  iteration per cycle.
* **Steady multi-unit set** — when the earliest and second-earliest
  wakes coincide (≥ 2 units runnable *now*), no unit can be skipped, but
  the whole runnable set can be granted the stretch jointly: the machine
  enters the steady regime loop, which executes the same AGU → CU → DU
  phase order cycle by cycle while the set stays ≥ 2 and contiguous
  (every next wake exactly one cycle ahead), without the per-cycle
  orchestration the outer loop carries (grant scans, window read-backs,
  termination checks).  The regime exits — back to the outer loop, which
  may grant a quiescent or LSQ window — as soon as a gap opens or the
  runnable set thins to one unit.  Bit-exactness is by construction:
  each cycle inside the regime performs exactly the phase sequence the
  reference model would.

Both pipeline shapes are accounted separately from quiescent windows
(``MachineResult.pipeline_grants`` / ``pipeline_cycles``): coverage
reported for load-dense kernels is the fraction of simulated cycles that
ran under a multi-unit grant.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

INF = float("inf")


class EventQueue:
    """Earliest-wakeup scheduler over a fixed set of registered units."""

    __slots__ = ("units",)

    def __init__(self) -> None:
        self.units: List[object] = []

    def register(self, unit) -> None:
        self.units.append(unit)

    def schedule(self, unit, cycle) -> None:
        """Request that ``unit`` run no later than ``cycle``."""
        if cycle < unit.wake:
            unit.wake = cycle

    def next_cycle(self) -> Optional[float]:
        """Earliest pending wakeup cycle, or None if none pending."""
        w = INF
        for u in self.units:
            uw = u.wake
            if uw < w:
                w = uw
        return None if w is INF else w

    def next_two(self) -> Tuple[float, Optional[object], float]:
        """``(earliest, its unit, second-earliest)`` over registered units.

        The spec (and test hook) for the machine loop's inlined scan: the
        returned unit is a candidate for a batch-window grant when it is a
        slice process and ``second > earliest + 1`` (see the module
        docstring).  Ties yield ``second == earliest``, which correctly
        forbids a grant.  ``earliest`` is ``INF`` when nothing is pending.
        """
        w1 = w2 = INF
        u1: Optional[object] = None
        for u in self.units:
            uw = u.wake
            if uw < w1:
                w2 = w1
                w1 = uw
                u1 = u
            elif uw < w2:
                w2 = uw
        return w1, u1, w2

    def runnable(self, cycle) -> List[object]:
        """Units whose pending wakeup is due at or before ``cycle``.

        The spec (and test hook) for the steady-state grant: a pipeline
        window may carry the machine through a stretch exactly while this
        set has ≥ 2 members every cycle (see the module docstring) —
        equivalently, while ``next_two`` keeps returning ``w1 == w2``.
        """
        return [u for u in self.units if u.wake <= cycle]
