"""Bounded latency-FIFOs with wakeup edges.

Each FIFO knows the two ends of its wire and lowers the ``wake`` cycle of
whoever a state change might unblock (the inlined fast path of
``EventQueue.schedule`` — see :mod:`repro_torch.core.sim.events`):

* ``push`` makes the item poppable at ``now + lat`` — the owning LSQ (for
  request / store-value FIFOs) is woken for that cycle, and any slice
  process parked waiting to pop is woken at ``max(now + 1, now + lat)``
  (a process's phase in cycle ``now`` has already run by the time a push
  from the LSQ phase lands, so it can observe the item next cycle at the
  earliest — matching the AGU→CU→DU phase order of the reference model).
* ``pop`` frees a slot — any process parked waiting to push is woken at
  ``now + 1`` (same phase-order argument), and the owning LSQ (for
  load-value / response FIFOs) is woken at ``now`` since the DU phase runs
  after the slice phases and can use the freed slot the same cycle.

Timestamps ride with the items: the queue holds ``(arrival_cycle, item)``.

``push_run``/``pop_run`` are the bulk-transfer forms of the same edges:
one splice moves a whole arrival-stamped run and collapses the wakeup
edges into the single minimum the scalar sequence would have left behind
(producer/consumer wakes are monotone minima).  ``push_run`` carries the
compiled LSQ run-tick (:meth:`repro_torch.core.sim.units.LSQ.tick_run`), which
retires an arrival-sorted run of loads in one step inside a pipeline
window; ``pop_run`` is its symmetric counterpart for the not-yet-built
accept-run fast path — both are held to the scalar sequence by the
property tests in ``tests/test_sim_windows.py``.

FIFO edges are also what bound **batch windows**: a slice process granted
a quiescent window (see :mod:`repro_torch.core.sim.events`) may consume cycles
on its own only while no other unit can run, so after every ``push``/
``pop`` it must clamp its window end to the woken LSQ's new ``wake`` (a
pop edge lowers it to the current cycle, closing the window so the DU
phase of that same cycle runs in the usual order).  The compiled slices
inline these edges and carry the clamp next to each inlined wake update;
the interpreted :class:`~repro_torch.core.sim.units.SliceProc` goes through the
methods below and clamps right after the call.
"""
from __future__ import annotations

from collections import deque
from typing import Any, List


class Fifo:
    __slots__ = ("q", "depth", "lat", "name", "lsq", "lsq_on_push",
                 "lsq_on_pop", "push_waiters", "pop_waiters")

    def __init__(self, name: str, depth: int, lat: int):
        self.q: deque = deque()
        self.depth = depth
        self.lat = lat
        self.name = name
        self.lsq = None           # owning LSQ unit (wired by the Machine)
        self.lsq_on_push = False  # LSQ is the reader (req / st_val)
        self.lsq_on_pop = False   # LSQ is the writer (ld_val / agu_resp)
        self.push_waiters: List[Any] = []  # procs parked on can_push
        self.pop_waiters: List[Any] = []   # procs parked on can_pop

    def can_push(self) -> bool:
        return len(self.q) < self.depth

    def push(self, now: int, item: Any) -> None:
        arrival = now + self.lat
        self.q.append((arrival, item))
        if self.lsq_on_push:
            lsq = self.lsq
            if arrival < lsq.wake:
                lsq.wake = arrival
        w = self.pop_waiters
        if w:
            t = arrival if arrival > now else now + 1
            for p in w:
                if t < p.wake:
                    p.wake = t
            del w[:]

    def push_run(self, now: int, stamped: List[Any]) -> None:
        """Bulk push of pre-stamped ``(arrival, item)`` pairs as one splice.

        Semantically identical to pushing the items one at a time at their
        stamped cycles (arrivals must be non-decreasing and the caller must
        have checked capacity for the whole run — back-pressure is a grant
        precondition, not re-checked here).  The wakeup edges collapse: a
        parked consumer's ``wake`` only ever takes the *minimum*, so waking
        it for the first arrival is exactly what n sequential pushes would
        have left behind; the owning LSQ (if it reads this FIFO) likewise
        wakes for the first arrival.  Used by the compiled LSQ run-tick
        (:meth:`repro_torch.core.sim.units.LSQ.tick_run`) to retire an
        arrival-sorted run of loads in one step.
        """
        if not stamped:
            return
        self.q.extend(stamped)
        first = stamped[0][0]
        if self.lsq_on_push:
            lsq = self.lsq
            if first < lsq.wake:
                lsq.wake = first
        w = self.pop_waiters
        if w:
            t = first if first > now else now + 1
            for p in w:
                if t < p.wake:
                    p.wake = t
            del w[:]

    def pop_run(self, now: int, k: int) -> List[Any]:
        """Bulk pop of ``k`` items as one splice; returns the items.

        Equivalent to ``k`` sequential ``pop`` calls made at cycles
        ``now .. now+k-1`` (the caller guarantees every popped head had
        arrived by its pop cycle): each pop would wake a parked producer at
        ``pop_cycle + 1`` and producer wakes are monotone minima, so one
        edge at ``now + 1`` is what the sequence would have left behind.
        The LSQ-on-pop edge lowers the owner's wake to ``now`` exactly as
        the first sequential pop would.

        No production caller yet: this is the request-side splice the
        run-tick's accept-run extension will use (see ROADMAP follow-ups);
        until then it is exercised by the bulk-FIFO property tests only.
        """
        q = self.q
        items = [q.popleft()[1] for _ in range(k)]
        if k:
            if self.lsq_on_pop:
                lsq = self.lsq
                if now < lsq.wake:
                    lsq.wake = now
            w = self.push_waiters
            if w:
                t = now + 1
                for p in w:
                    if t < p.wake:
                        p.wake = t
                del w[:]
        return items

    def can_pop(self, now: int) -> bool:
        return bool(self.q) and self.q[0][0] <= now

    def pop(self, now: int) -> Any:
        item = self.q.popleft()[1]
        if self.lsq_on_pop:
            lsq = self.lsq
            if now < lsq.wake:
                lsq.wake = now
        w = self.push_waiters
        if w:
            t = now + 1
            for p in w:
                if t < p.wake:
                    p.wake = t
            del w[:]
        return item

    def __len__(self) -> int:
        return len(self.q)
