"""Machine model of the paper's DAE architecture (§8.1) — event-driven.

Three communicating processes per the Fig. 1 template:

* **AGU** — executes the address slice; ``send_ld``/``send_st`` push requests
  into per-array request FIFOs.  A *sync* ``send_ld`` (loss-of-decoupling)
  additionally blocks on the DU's response queue — the Fig. 1b round trip.
* **DU** — one load-store queue per decoupled array (load q=4 / store q=32 as
  in §8.1): loads complete out of order (dynamic disambiguation against older
  store addresses, store-to-load forwarding, skipping poisoned stores) but
  deliver in order; stores commit in order once their value or poison token
  arrives; **poisoned stores retire without writing** — the paper's
  no-replay, no out-of-bounds-commit guarantee.
* **CU** — executes the compute slice; ``consume_ld`` pops load values,
  ``produce_st``/``poison_st`` push store values / kill tokens.

All FIFOs are bounded and have a transfer latency, so back-pressure and
round-trip costs emerge naturally (the DAE-without-speculation slowdown of
Fig. 6 is the coupling of the AGU to the CU through full/empty queues).

Engine
------
The simulation is **event-driven** (:mod:`repro_torch.core.sim`): units advance in
bursts until they block on a FIFO full/empty or memory-latency condition,
park on the event queue, and time jumps straight to the next
``(ready_cycle, unit)`` wakeup instead of ticking through idle cycles.  The
model is cycle-exact: it produces bit-identical cycle counts, poison/commit
counts, load counts, and store traces to the original cycle-stepped
implementation (kept as the golden oracle in
``tests/ref_machine_cyclestep.py`` and asserted against in
``tests/test_sim_equivalence.py``).

On top of the event scheduler sit two opt-in window engines:

* **Batch windows** (``MachineConfig(batch_window=True)``, or
  ``DAE_SIM_WINDOW=1`` machine wide): when the wakeup scan shows that a
  single slice process is the only unit able to make progress before
  cycle T — no FIFO edge, no LSQ retirement, no poison event can fire in
  between — the machine grants it the window ``[now, T)`` and the
  process advances through the whole stretch in one step instead of one
  event per cycle, clamping the window whenever one of its own FIFO
  edges wakes the LSQ early.
* **Steady-state pipeline windows**
  (``MachineConfig(pipeline_window=True)``, or ``DAE_SIM_PIPELINE=1``;
  implies the slice grant above): the multi-unit extension for the
  paper's load-dense kernels, where AGU, CU, and LSQ are all busy nearly
  every cycle and quiescent windows almost never fire.  A sole-runnable
  LSQ advances through its stretch with the compiled run-tick
  (``LSQ.tick_run`` — arrival-sorted retirement and in-order commit runs
  collapse into single FIFO splices), and stretches with >= 2 units
  runnable back to back run under one grant in the steady regime loop
  (``Machine._steady``), which keeps the reference AGU→CU→DU phase order
  without the per-cycle orchestration.  See
  :mod:`repro_torch.core.sim.events` for the proof obligations of both grant
  shapes.

Windowed runs of either kind are bit-identical to the event-stepped and
cycle-stepped models — the three-engine differential suite
(``tests/test_sim_equivalence.py``) runs every workload in every mode.
``MachineResult`` accounts the kinds separately (``window_grants`` /
``window_cycles`` for slice windows, ``pipeline_grants`` /
``pipeline_cycles`` for multi-unit grants; ``window_hit_rate`` is the
combined coverage); ``benchmarks/dae_quiescent.py`` measures the
wall-time win on quiescent-heavy workloads and ``benchmarks/dae_table1.py``
the coverage/wall A/B on the paper's load-dense kernels.

Invariants the event wiring preserves (and that any new unit must also
honour — see :mod:`repro_torch.core.sim.events` for why):

* **FIFO back-pressure** — every FIFO is bounded; a full FIFO parks the
  producer, an empty one parks the consumer, and each push/pop edge
  schedules the wakeup of whoever it might unblock.
* **In-order delivery** — load values and AGU sync responses leave the LSQ
  in request order; stores commit in order at one per cycle.
* **No-replay poison retirement** — a poisoned store consumes its queue
  slot and retires without writing; requests are never re-issued.
* **Phase order** — within one simulated cycle, AGU runs before CU, and all
  LSQs tick after both slices.  A push landing in cycle *t* is observable
  by a later phase of *t* but only by earlier phases at *t + 1*.

Adding a new unit means: give it a ``wake`` attribute, run it from
``sim.units.Machine.run`` in a fixed phase position, and make sure every
state change that could unblock it schedules a wakeup (a spurious wakeup is
harmless; a missed one breaks cycle-exactness).

``run_sta`` models the industry-HLS static baseline: if-converted in-order
issue with width ``sta_width``, loads conservatively ordered behind every
older same-array store commit ("loads that cannot be disambiguated at compile
time execute in order", §8.1.1).  It is a one-pass analytic schedule, not a
simulation, and lives here unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .interp import eval_binop
from .ir import Function
from .sim import (Deadlock, EventQueue, Fifo, LSQ, Machine, MachineConfig,
                  MachineResult, POISON, SliceProc, run_dae)

__all__ = ["Deadlock", "EventQueue", "Fifo", "LSQ", "Machine",
           "MachineConfig", "MachineResult", "POISON", "SliceProc",
           "run_dae", "run_sta"]


# ---------------------------------------------------------------------------
# STA baseline: if-converted in-order static schedule
# ---------------------------------------------------------------------------


def run_sta(fn: Function, memory: Dict[str, np.ndarray],
            params: Optional[Dict[str, Any]] = None,
            cfg: Optional[MachineConfig] = None) -> MachineResult:
    """Static-scheduling model (§8.1.1 STA): in-order issue of width
    ``sta_width``; every load waits for all older same-array store commits
    (no dynamic disambiguation); dataflow latencies otherwise overlap.

    Functions in the STA op set run through the compiled fast path
    (:func:`repro_torch.core.sim.compile.compile_sta` — bit-identical schedule);
    anything else falls through to the interpreted model below.
    """
    cfg = cfg or MachineConfig()
    from .sim.compile import compile_sta
    fast = compile_sta(fn)
    if fast is not None:
        return fast(memory, dict(params or {}), cfg)
    env: Dict[str, Any] = dict(params or {})
    regs: Dict[str, Any] = {}
    res = MachineResult(cycles=0)

    ready: Dict[str, float] = {}
    last_store_commit: Dict[str, float] = {}
    t = 0.0
    slots = 0

    def issue(dep: float) -> float:
        nonlocal t, slots
        if dep > t:
            t, slots = dep, 0
        if slots >= cfg.sta_width:
            t, slots = t + 1, 0
        slots += 1
        return t

    cur = fn.entry
    prev: Optional[str] = None
    steps = 0
    while True:
        blk = fn.blocks[cur]
        if blk.phis:
            vals = {}
            for p in blk.phis:
                for (pb, v) in p.args:
                    if pb == prev:
                        vals[p.dest] = env.get(v)
                        ready[p.dest] = ready.get(v, t)
                        break
            env.update(vals)
        for instr in blk.body:
            steps += 1
            if steps > cfg.max_cycles:
                raise Deadlock("STA step budget exceeded")
            dep = max([ready.get(u, 0.0) for u in instr.uses()] + [0.0])
            op = instr.op
            if op == "const":
                env[instr.dest] = instr.args[0]
                ready[instr.dest] = 0.0
            elif op == "bin":
                o, a, b = instr.args
                env[instr.dest] = eval_binop(o, _v(env, a), _v(env, b))
                ready[instr.dest] = issue(dep) + 1
            elif op == "select":
                c, a, b = instr.args
                env[instr.dest] = _v(env, a) if _v(env, c) else _v(env, b)
                ready[instr.dest] = issue(dep) + 1
            elif op == "load":
                at = issue(max(dep, last_store_commit.get(instr.array, 0.0)))
                a = int(_v(env, instr.args[0]))
                arr = memory[instr.array]
                a = min(max(a, 0), len(arr) - 1)
                env[instr.dest] = arr[a].item()
                ready[instr.dest] = at + cfg.mem_lat
                res.loads_served += 1
            elif op == "store":
                at = issue(dep)
                arr = memory[instr.array]
                a = int(_v(env, instr.args[0]))
                arr[a] = _v(env, instr.args[1])
                last_store_commit[instr.array] = at + 1
                res.stores_committed += 1
                res.store_trace.setdefault(instr.array, []).append(
                    (a, _v(env, instr.args[1])))
            elif op == "setreg":
                regs[instr.args[0]] = (instr.meta["imm"]
                                       if "imm" in instr.meta
                                       else _v(env, instr.args[1]))
            elif op == "getreg":
                env[instr.dest] = regs.get(instr.args[0], 0)
                ready[instr.dest] = t
            else:
                raise RuntimeError(f"STA cannot execute {op}")
        term = blk.term
        if term.kind == "ret":
            res.cycles = int(max([t] + list(ready.values())))
            return res
        if not blk.synthetic:
            prev = cur
        if term.kind == "br":
            cur = term.targets[0]
        else:
            # if-converted spatial datapath (§8.1.1): control does not stall
            # issue — branches become predication; only dataflow (operand
            # readiness) and the in-order same-array load/store discipline
            # gate the static schedule.
            cur = term.targets[0 if bool(env[term.cond]) else 1]


def _v(env: Dict[str, Any], a: Any) -> Any:
    return env[a] if isinstance(a, str) else a
