"""AGU / DU / CU processes for the event-driven DAE machine.

The three units of the Fig. 1 template, recast as event-driven processes:

* :class:`SliceProc` (AGU and CU) — executes one slice as a generator that
  yields once per *simulated* cycle, exactly like the cycle-stepped
  reference model, except that a blocking FIFO condition **parks** the
  process (``park`` is set before the yield) instead of spinning: the
  machine loop stops resuming it until a FIFO edge schedules a wakeup.
  Slices that lower cleanly run as compiled generators
  (:mod:`repro_torch.core.sim.compile`); the interpreted ``run`` generator is the
  fallback and the readable spec of the yield discipline.
* :class:`LSQ` (the DU) — one load-store queue per decoupled array.  Its
  ``tick`` is the reference model's, cycle-for-cycle; load/store queue
  entries are plain lists (``_L*``/``_S*`` index constants below) rather
  than dicts purely for speed.  After a tick that made no progress it
  reports the next *timed* cycle anything could change (earliest request /
  store-value arrival, earliest load completion) so the machine can jump
  time forward.  ``tick_run`` is the **compiled tick** behind pipeline
  windows: granted a sole-runnable stretch, it advances through it in one
  call, collapsing provable streaming shapes (an arrival-sorted run of
  load retirements, an in-order run of store commits) into single splices
  and falling back to the scalar ``tick`` — its spec — everywhere else.

:class:`Machine` owns the scheduler loop.  Per executed cycle the phase
order is AGU, CU, then each LSQ in sorted-array order — identical to the
reference model, which is what makes the two bit-identical (see
``tests/test_sim_equivalence.py``).  With
``MachineConfig(pipeline_window=True)`` the loop additionally grants
steady-state multi-unit windows: stretches where >= 2 units stay
runnable back to back run inside ``Machine._steady`` (the regime loop —
same phase order, none of the per-cycle orchestration), and
sole-runnable LSQ stretches run under ``LSQ.tick_run``.  The
three-engine differential suite holds every mode to the same
bit-for-bit bar.
"""
from __future__ import annotations

from typing import Any, Dict, Generator, Optional, Set, Tuple

import numpy as np

from ..interp import eval_binop
from ..ir import Function
from .base import Deadlock, MachineConfig, MachineResult, POISON
from .events import INF, EventQueue
from .fifo import Fifo

PARK_PUSH = 1  # waiting for space in a FIFO (req / st_val)
PARK_POP = 2   # waiting for data in a FIFO (ld_val / agu_resp)

# load entry: [seq, addr, sync, done, value, stall_epoch]
_LSEQ, _LADDR, _LSYNC, _LDONE, _LVAL, _LEPOCH = range(6)
# store entry: [seq, addr, value, poison, has_value]
_SSEQ, _SADDR, _SVAL, _SPOISON, _SHASVAL = range(5)


# ---------------------------------------------------------------------------
# Load-store queue (one per decoupled array)
# ---------------------------------------------------------------------------


class LSQ:
    __slots__ = ("array", "mem", "mem_list", "mem_hi", "cfg", "ldq", "stq",
                 "mem_lat", "res", "seq", "loads", "stores", "n_valued", "epoch", "_cast",
                 "req", "ld_val", "agu_resp", "st_val", "wake", "_trace",
                 "_peers")

    def __init__(self, array: str, mem: np.ndarray, cfg: MachineConfig,
                 res: MachineResult):
        self.array = array
        self.mem = mem
        # plain-list mirror: scalar reads/writes are several times cheaper
        # than numpy item access; flush() writes back before run() returns.
        # Commits coerce through the array dtype (_cast) so later loads
        # observe exactly what a numpy store would have kept.
        self.mem_list = mem.tolist()
        self._cast = mem.dtype.type
        self.mem_hi = len(mem) - 1
        self.cfg = cfg
        self.ldq = cfg.ldq
        self.stq = cfg.stq
        self.mem_lat = cfg.mem_lat
        self.res = res
        self.seq = 0
        self.loads: list = []   # list entries, arrival order
        self.stores: list = []  # list entries, arrival order
        # valued-prefix pointer: store values (and poison tokens) arrive in
        # order and commits pop valued heads, so stores[:n_valued] always
        # have values and stores[n_valued] is the next to receive one
        self.n_valued = 0
        # disambiguation epoch: a load's stall verdict can only change when
        # a store gains its value/poison or a store commits — bump then,
        # and skip re-scanning loads whose cached verdict is current
        self.epoch = 0
        self.wake: float = INF
        self._trace = None  # res.store_trace[array], bound on first commit
        self._peers: list = [self]  # every LSQ of the machine (incl. self),
        # rebound by the Machine — tick_run's termination fence needs them
        # FIFOs (filled in by the Machine)
        self.req: Fifo = None  # type: ignore[assignment]
        self.ld_val: Fifo = None  # type: ignore[assignment]
        self.agu_resp: Fifo = None  # type: ignore[assignment]
        self.st_val: Fifo = None  # type: ignore[assignment]

    def tick(self, now: int) -> bool:
        """One DU cycle; returns True if any progress was made.

        FIFO pops/pushes are inlined (equivalent to ``Fifo.pop``/``push``
        with the LSQ-edge flags this LSQ's FIFOs carry) — this method runs
        once per non-idle simulated cycle and is the hottest code in the
        simulator.
        """
        busy = False
        loads = self.loads
        stores = self.stores
        res = self.res

        # 1. accept one request from the AGU
        req = self.req
        rq = req.q
        if rq:
            head = rq[0]
            if head[0] <= now:
                kind, addr, sync = head[1]
                if kind == "ld":
                    if len(loads) < self.ldq:
                        rq.popleft()  # inline req.pop: wake parked pusher
                        w = req.push_waiters
                        if w:
                            t = now + 1
                            for p in w:
                                if t < p.wake:
                                    p.wake = t
                            del w[:]
                        loads.append([self.seq, addr, sync, None, None, -1])
                        self.seq += 1
                        busy = True
                elif len(stores) < self.stq:
                    rq.popleft()
                    w = req.push_waiters
                    if w:
                        t = now + 1
                        for p in w:
                            if t < p.wake:
                                p.wake = t
                        del w[:]
                    stores.append([self.seq, addr, None, False, False])
                    self.seq += 1
                    busy = True

        # 2. accept one store value / poison token from the CU (values
        # fill stores in order: the valued prefix grows by one)
        stv = self.st_val
        svq = stv.q
        if svq and svq[0][0] <= now and self.n_valued < len(stores):
            st = stores[self.n_valued]
            tok = svq.popleft()[1]  # inline st_val.pop
            w = stv.push_waiters
            if w:
                t = now + 1
                for p in w:
                    if t < p.wake:
                        p.wake = t
                del w[:]
            st[_SHASVAL] = True
            if tok is POISON:
                st[_SPOISON] = True
            else:
                st[_SVAL] = tok
            self.n_valued += 1
            self.epoch += 1
            busy = True

        # 3. load issue / forward (1 memory read port + 1 forwarding bypass)
        issued_read = False
        forwarded = False
        epoch = self.epoch
        for ld in loads:
            if ld[_LDONE] is not None:
                continue
            if ld[_LEPOCH] == epoch:
                continue  # cached verdict: still stalled, stores unchanged
            # RAW check against older stores, youngest-first: an address
            # match with a known non-poisoned value forwards; a poisoned
            # match is skipped (never committed); an unknown value stalls
            # the load (may alias).  Unknown *addresses* cannot occur — the
            # request FIFO delivers in program order, so every older
            # store's address is already here.
            lseq = ld[_LSEQ]
            laddr = ld[_LADDR]
            hit = stall = False
            value = None
            for st in reversed(stores):
                if st[_SSEQ] > lseq:
                    continue
                if st[_SADDR] != laddr:
                    continue
                if not st[_SHASVAL]:
                    stall = True
                    break
                if st[_SPOISON]:
                    continue
                hit = True
                value = st[_SVAL]
                break
            if stall:
                ld[_LEPOCH] = epoch
                continue  # OoO: younger loads may still proceed
            if hit:
                if not forwarded:
                    ld[_LDONE] = now + 1
                    ld[_LVAL] = value
                    forwarded = True
                    busy = True
            elif not issued_read:
                a = int(laddr)
                if a < 0:           # speculative clamp
                    a = 0
                elif a > self.mem_hi:
                    a = self.mem_hi
                ld[_LDONE] = now + self.mem_lat
                ld[_LVAL] = self.mem_list[a]
                issued_read = True
                busy = True

        # 4. in-order delivery of completed loads
        if loads:
            ld = loads[0]
            d = ld[_LDONE]
            if d is not None and d <= now:
                ldv = self.ld_val
                if len(ldv.q) < ldv.depth:
                    if ld[_LSYNC]:
                        resp = self.agu_resp
                        if len(resp.q) < resp.depth:
                            self._deliver(ldv, now, ld[_LVAL])
                            self._deliver(resp, now, ld[_LVAL])
                            loads.pop(0)
                            res.loads_served += 1
                            busy = True
                    else:
                        self._deliver(ldv, now, ld[_LVAL])
                        loads.pop(0)
                        res.loads_served += 1
                        busy = True

        # 5. in-order store commit (1 write port)
        if stores:
            st = stores[0]
            if st[_SHASVAL]:
                if st[_SPOISON]:
                    res.stores_poisoned += 1
                else:
                    a = int(st[_SADDR])
                    if not (0 <= a <= self.mem_hi):
                        raise RuntimeError(
                            f"non-poisoned store out of bounds: "
                            f"{self.array}[{a}]")
                    self.mem_list[a] = self._cast(st[_SVAL]).item()
                    res.stores_committed += 1
                    trace = self._trace
                    if trace is None:
                        trace = self._trace = res.store_trace.setdefault(
                            self.array, [])
                    trace.append((a, st[_SVAL]))
                stores.pop(0)
                self.n_valued -= 1
                self.epoch += 1
                busy = True

        occ = len(loads) + len(stores)
        if occ > res.lsq_high_water:
            res.lsq_high_water = occ

        # schedule own wakeup: busy → run again next cycle; idle → only
        # time can unblock from inside (request/store-value arrival, load
        # completion); external edges lower `wake` on their own
        if busy:
            self.wake = now + 1
        else:
            w = INF
            if rq:
                a = rq[0][0]
                if a > now:
                    w = a
            if svq:
                a = svq[0][0]
                if now < a < w:
                    w = a
            for ld in loads:
                d = ld[_LDONE]
                if d is not None and now < d < w:
                    w = d
            self.wake = w
        return busy

    def tick_run(self, start: int, end, agu, cu) -> int:
        """Advance this LSQ alone through ``[start, end)`` — the compiled
        tick behind sole-LSQ pipeline windows.

        Grant premise (discharged by the machine's wakeup scan): no other
        unit has a pending wakeup before ``end``.  Every FIFO edge this
        LSQ performs may lower a slice's ``wake`` into the run, so both
        slice wakes are re-read before entering each further cycle — the
        run clamp, mirroring the slice-window clamp.  Two provable steady
        shapes collapse into one step instead of one scalar tick per
        cycle:

        * **retirement runs** — every in-flight load issued, no store in
          flight, no request arrival before the horizon: the only
          per-cycle effect is the in-order delivery of the head load, so
          an arrival-sorted run of completed loads retires as one splice
          (:meth:`~repro_torch.core.sim.fifo.Fifo.push_run`), preserving
          in-order delivery and the one-delivery-per-cycle discipline
          (delivery cycles ``c_i = max(c_{i-1}+1, done_i)``);
        * **commit runs** — every queued store valued, no load in flight,
          no request arrival before the horizon: stores commit in order,
          one per cycle, poisoned stores retiring without writing
          (no-replay), as one pass over the valued prefix — commits raise
          no wakeup edge, so the run is bounded only by the horizon.

        Everything else falls through to the scalar ``tick``, cycle for
        cycle (with in-run time jumps over idle gaps), so the run is
        bit-identical to per-cycle execution by construction
        (property-tested against the scalar tick on randomized schedules
        in ``tests/test_sim_windows.py``).  Returns the last cycle
        executed; ``self.wake`` is left correct for the next scan.
        """
        now = start
        loads = self.loads
        stores = self.stores
        rq = self.req.q
        res = self.res
        while True:
            # horizon: cycles [now, hz) are provably free of external
            # arrivals (request head) and of any other unit's wakeup.
            # Store-value heads never bound a batch: with no store in
            # flight (retirement run) or every store valued (commit run)
            # the st_val accept step is inert until a new store request
            # is accepted, and requests are capped separately.
            hz = end
            aw = agu.wake
            if aw < hz:
                hz = aw
            cw = cu.wake
            if cw < hz:
                hz = cw
            batched = False
            if rq:
                a = rq[0][0]
                if a < hz:
                    hz = a
                req_quiet = a > now
            else:
                req_quiet = True
            if req_quiet and hz > now + 1:
                if not stores:
                    # ---- retirement run ----
                    ld0 = loads[0] if loads else None
                    if (ld0 is not None and ld0[_LDONE] is not None
                            and ld0[_LDONE] <= now
                            and all(ld[_LDONE] is not None for ld in loads)):
                        ldv = self.ld_val
                        room = ldv.depth - len(ldv.q)
                        lat = ldv.lat
                        cap = hz
                        if ldv.pop_waiters:
                            # the first push wakes the parked consumer at
                            # its arrival; cycles from there aren't ours
                            first_wake = now + lat if lat > 0 else now + 1
                            if first_wake < cap:
                                cap = first_wake
                        stamped = []
                        c = now - 1
                        for ld in loads:
                            if len(stamped) >= room or ld[_LSYNC]:
                                break
                            c2 = c + 1
                            d = ld[_LDONE]
                            if d > c2:
                                c2 = d
                            if c2 >= cap:
                                break
                            stamped.append((c2 + lat, ld[_LVAL]))
                            c = c2
                        k = len(stamped)
                        if k > 1:
                            ldv.push_run(now, stamped)
                            del loads[:k]
                            res.loads_served += k
                            # scalar ticks record occupancy per cycle; a
                            # shrinking run's max is after its first cycle
                            occ = len(loads) + k - 1
                            if occ > res.lsq_high_water:
                                res.lsq_high_water = occ
                            now = c
                            self.wake = c + 1
                            batched = True
                elif not loads and self.n_valued == len(stores):
                    # ---- commit run ----
                    k = len(stores)
                    span = hz - now
                    if k > span:
                        k = span
                    if k > 1:
                        trace = self._trace
                        mem_list = self.mem_list
                        hi = self.mem_hi
                        cast = self._cast
                        for i in range(k):
                            st = stores[i]
                            if st[_SPOISON]:
                                res.stores_poisoned += 1
                            else:
                                a = int(st[_SADDR])
                                if not (0 <= a <= hi):
                                    raise RuntimeError(
                                        f"non-poisoned store out of bounds: "
                                        f"{self.array}[{a}]")
                                mem_list[a] = cast(st[_SVAL]).item()
                                res.stores_committed += 1
                                if trace is None:
                                    trace = self._trace = \
                                        res.store_trace.setdefault(
                                            self.array, [])
                                trace.append((a, st[_SVAL]))
                        occ = len(stores) - 1  # after the first commit
                        if occ > res.lsq_high_water:
                            res.lsq_high_water = occ
                        del stores[:k]
                        self.n_valued -= k
                        self.epoch += k
                        now = now + k - 1
                        self.wake = now + 1
                        batched = True
            if not batched:
                self.tick(now)  # scalar cycle: the readable spec
            # machine-termination fence: the outer loop checks "slices
            # done + all LSQs drained" between cycles and records the
            # cycle count there, so the run must not coast past the drain
            # point on the busy tick's own next-cycle wakeup
            if agu.done and cu.done:
                for lsq in self._peers:
                    if not lsq.drained():
                        break
                else:
                    return now
            # run clamp: stop before the first cycle any other unit (or
            # the grant end) could claim; jump idle gaps inside the run
            nxt = self.wake
            limit = end
            aw = agu.wake
            if aw < limit:
                limit = aw
            cw = cu.wake
            if cw < limit:
                limit = cw
            if nxt >= limit:
                return now
            now = nxt

    @staticmethod
    def _deliver(fifo: Fifo, now: int, value: Any) -> None:
        """Inline of ``Fifo.push`` for DU-written FIFOs (no LSQ-on-push
        edge): append and wake any parked consumer."""
        arrival = now + fifo.lat
        fifo.q.append((arrival, value))
        w = fifo.pop_waiters
        if w:
            t = arrival if arrival > now else now + 1
            for p in w:
                if t < p.wake:
                    p.wake = t
            del w[:]

    def flush(self) -> None:
        """Write the list mirror back to the caller's numpy array."""
        self.mem[:] = self.mem_list

    def drained(self) -> bool:
        return (not self.loads and not self.stores and not len(self.req)
                and not len(self.st_val) and not len(self.ld_val)
                and not len(self.agu_resp))


# ---------------------------------------------------------------------------
# Slice processes (AGU / CU)
# ---------------------------------------------------------------------------


class SliceProc:
    """Executes one slice; a generator yields once per simulated cycle.

    Instead of spinning one yield per blocked cycle, a blocked FIFO op sets
    ``park = (mode, fifo)`` before yielding; the machine resumes the
    process only when a wakeup fires, and the ``while`` re-checks the
    condition (a spurious wakeup just parks again — semantics identical to
    the reference model's per-cycle re-check).

    Batch windows: when the machine grants this process the half-open
    window ``[self._now, self.window_end)`` (every other unit provably
    quiet until then — see :mod:`repro_torch.core.sim.events`), the generator may
    *consume* cycles by advancing ``self._now`` itself instead of yielding,
    one machine round trip for the whole stretch.  Every FIFO push/pop must
    then clamp ``window_end`` to the woken LSQ's new ``wake`` so the
    quiescence premise keeps holding; a window is permission, not
    obligation — ignoring it (``window_end`` is 0 outside a grant) is
    exactly the reference behaviour.
    """

    def __init__(self, name: str, fn: Function, params: Dict[str, Any],
                 local_mem: Dict[str, np.ndarray], lsqs: Dict[str, "LSQ"],
                 cfg: MachineConfig, res: MachineResult, is_agu: bool):
        self.name = name
        self.fn = fn
        self.env: Dict[str, Any] = dict(params)
        self.regs: Dict[str, Any] = {}
        self.local = local_mem
        self.lsqs = lsqs
        self.cfg = cfg
        self.res = res
        self.is_agu = is_agu
        self.done = False
        self.blocked_on = ""
        self.park: Optional[Tuple[int, Fifo]] = None
        self.wake: float = INF
        self._now = 0
        # first cycle this process may NOT consume on its own; 0 = no window
        self.window_end: float = 0

    def now(self) -> int:
        return self._now

    def make_gen(self) -> Generator[None, None, None]:
        """Compiled generator when the slice lowers; interpreted otherwise."""
        from .compile import compile_slice
        make = compile_slice(self.fn)
        return make(self) if make is not None else self.run()

    def run(self) -> Generator[None, None, None]:
        self._now = 0
        env, regs = self.env, self.regs
        cur = self.fn.entry
        prev: Optional[str] = None
        budget = self.cfg.width

        def step():  # one simulated cycle
            nonlocal budget
            budget = self.cfg.width
            return None

        while True:
            blk = self.fn.blocks[cur]
            if blk.phis:
                vals = {}
                for p in blk.phis:
                    for (pb, v) in p.args:
                        if pb == prev:
                            vals[p.dest] = env.get(v)
                            break
                    else:
                        raise RuntimeError(
                            f"{self.name}: phi {p.dest} in {cur}: "
                            f"no incoming for {prev}")
                env.update(vals)

            for instr in blk.body:
                cost = 0 if instr.op in ("const", "getreg", "setreg") else 1
                if budget < cost:
                    if self._now + 1 < self.window_end:
                        self._now += 1  # consume the cycle inside the window
                        budget = self.cfg.width
                    else:
                        yield step()
                budget -= cost
                op = instr.op
                if op == "const":
                    env[instr.dest] = instr.args[0]
                elif op == "bin":
                    o, a, b = instr.args
                    env[instr.dest] = eval_binop(o, _v(env, a), _v(env, b))
                elif op == "select":
                    c, t, f = instr.args
                    env[instr.dest] = _v(env, t) if _v(env, c) else _v(env, f)
                elif op == "load":
                    a = int(_v(env, instr.args[0]))
                    arr = self.local[instr.array]
                    a = min(max(a, 0), len(arr) - 1)
                    env[instr.dest] = arr[a].item()
                elif op == "store":
                    arr = self.local[instr.array]
                    a = int(_v(env, instr.args[0]))
                    if 0 <= a < len(arr):
                        arr[a] = _v(env, instr.args[1])
                elif op == "setreg":
                    regs[instr.args[0]] = (instr.meta["imm"]
                                           if "imm" in instr.meta
                                           else _v(env, instr.args[1]))
                elif op == "getreg":
                    env[instr.dest] = regs.get(instr.args[0], 0)
                elif op == "send_ld":
                    lsq = self.lsqs[instr.array]
                    self.blocked_on = f"send_ld {instr.array}"
                    while not lsq.req.can_push():
                        self.park = (PARK_PUSH, lsq.req)
                        yield step()
                    self.park = None
                    sync = bool(instr.meta.get("sync"))
                    lsq.req.push(self._now, ("ld", int(_v(env, instr.args[0])),
                                             sync))
                    if lsq.wake < self.window_end:
                        self.window_end = lsq.wake  # window clamp
                    if sync:
                        self.res.sync_waits += 1
                        self.blocked_on = f"sync_resp {instr.array}"
                        while not lsq.agu_resp.can_pop(self._now):
                            q = lsq.agu_resp.q
                            if q and q[0][0] < self.window_end:
                                self._now = q[0][0]  # jump to head arrival
                                budget = self.cfg.width
                                continue
                            self.park = (PARK_POP, lsq.agu_resp)
                            yield step()
                        self.park = None
                        env[instr.dest] = lsq.agu_resp.pop(self._now)
                        if lsq.wake < self.window_end:
                            self.window_end = lsq.wake  # window clamp
                    self.blocked_on = ""
                elif op == "send_st":
                    lsq = self.lsqs[instr.array]
                    self.blocked_on = f"send_st {instr.array}"
                    while not lsq.req.can_push():
                        self.park = (PARK_PUSH, lsq.req)
                        yield step()
                    self.park = None
                    lsq.req.push(self._now, ("st", int(_v(env, instr.args[0])),
                                             False))
                    if lsq.wake < self.window_end:
                        self.window_end = lsq.wake  # window clamp
                    self.blocked_on = ""
                elif op == "consume_ld":
                    lsq = self.lsqs[instr.array]
                    self.blocked_on = f"consume_ld {instr.array}"
                    while not lsq.ld_val.can_pop(self._now):
                        q = lsq.ld_val.q
                        if q and q[0][0] < self.window_end:
                            self._now = q[0][0]  # jump to head arrival
                            budget = self.cfg.width
                            continue
                        self.park = (PARK_POP, lsq.ld_val)
                        yield step()
                    self.park = None
                    env[instr.dest] = lsq.ld_val.pop(self._now)
                    if lsq.wake < self.window_end:
                        self.window_end = lsq.wake  # window clamp
                    self.blocked_on = ""
                elif op == "produce_st":
                    lsq = self.lsqs[instr.array]
                    self.blocked_on = f"produce_st {instr.array}"
                    while not lsq.st_val.can_push():
                        self.park = (PARK_PUSH, lsq.st_val)
                        yield step()
                    self.park = None
                    lsq.st_val.push(self._now, _v(env, instr.args[0]))
                    if lsq.wake < self.window_end:
                        self.window_end = lsq.wake  # window clamp
                    self.blocked_on = ""
                elif op == "poison_st":
                    pr = instr.meta.get("pred_reg")
                    if pr is not None and not regs.get(pr, 0):
                        budget += 1  # predicated off: free
                        continue
                    lsq = self.lsqs[instr.array]
                    self.blocked_on = f"poison_st {instr.array}"
                    while not lsq.st_val.can_push():
                        self.park = (PARK_PUSH, lsq.st_val)
                        yield step()
                    self.park = None
                    lsq.st_val.push(self._now, POISON)
                    if lsq.wake < self.window_end:
                        self.window_end = lsq.wake  # window clamp
                    self.blocked_on = ""
                elif op == "print":
                    pass
                else:
                    raise RuntimeError(f"{self.name}: bad op {op}")

            term = blk.term
            if term.kind == "ret":
                self.done = True
                return
            if not blk.synthetic:
                prev = cur
            if term.kind == "br":
                cur = term.targets[0]
            else:
                cur = term.targets[0 if bool(env[term.cond]) else 1]
            if self._now + 1 < self.window_end:
                self._now += 1  # block boundary consumed inside the window
                budget = self.cfg.width
            else:
                yield step()  # block boundary


def _v(env: Dict[str, Any], a: Any) -> Any:
    return env[a] if isinstance(a, str) else a


# ---------------------------------------------------------------------------
# The machine: AGU + DU + CU under the event scheduler
# ---------------------------------------------------------------------------


class Machine:
    """Wires the units together and runs the event loop."""

    def __init__(self, agu: Function, cu: Function,
                 memory: Dict[str, np.ndarray], decoupled: Set[str],
                 params: Optional[Dict[str, Any]] = None,
                 cfg: Optional[MachineConfig] = None):
        self.cfg = cfg = cfg or MachineConfig()
        params = dict(params or {})
        self.res = res = MachineResult(cycles=0)
        self.evq = evq = EventQueue()

        self.lsqs: Dict[str, LSQ] = {}
        for a in sorted(decoupled):
            lsq = LSQ(a, memory[a], cfg, res)
            lsq.req = Fifo(f"{a}.req", cfg.fifo_depth, cfg.fifo_lat)
            lsq.ld_val = Fifo(f"{a}.ldval", cfg.fifo_depth, cfg.fifo_lat)
            lsq.agu_resp = Fifo(f"{a}.resp", cfg.fifo_depth, cfg.fifo_lat)
            lsq.st_val = Fifo(f"{a}.stval", cfg.fifo_depth, cfg.fifo_lat)
            for f in (lsq.req, lsq.ld_val, lsq.agu_resp, lsq.st_val):
                f.lsq = lsq
            # slice-facing edges: req/st_val are read by the DU phase,
            # ld_val/agu_resp are written by it (see fifo.py)
            lsq.req.lsq_on_push = lsq.st_val.lsq_on_push = True
            lsq.ld_val.lsq_on_pop = lsq.agu_resp.lsq_on_pop = True
            self.lsqs[a] = lsq

        agu_local = {a: memory[a].copy() for a in memory if a not in decoupled}
        cu_local = {a: memory[a] for a in memory if a not in decoupled}

        peers = list(self.lsqs.values())
        for lsq in peers:
            lsq._peers = peers

        self.agu_p = SliceProc("AGU", agu, params, agu_local, self.lsqs,
                               cfg, res, True)
        self.cu_p = SliceProc("CU", cu, params, cu_local, self.lsqs,
                              cfg, res, False)
        for u in (self.agu_p, self.cu_p, *self.lsqs.values()):
            evq.register(u)

    def run(self) -> MachineResult:
        # the hot loop allocates millions of short-lived FIFO tuples and
        # queue entries; none form cycles, so pause the cyclic GC rather
        # than letting it rescan the arena every few thousand allocations
        import gc
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            return self._run()
        finally:
            if gc_was_enabled:
                gc.enable()
            for lsq in self.lsqs.values():
                lsq.flush()

    def _run(self) -> MachineResult:
        evq, res, cfg = self.evq, self.res, self.cfg
        agu_p, cu_p = self.agu_p, self.cu_p
        lsq_list = self._lsq_list = list(self.lsqs.values())
        lsq0 = lsq_list[0] if len(lsq_list) == 1 else None
        agu_gen = self._agu_gen = agu_p.make_gen()
        cu_gen = self._cu_gen = cu_p.make_gen()
        agu_next = agu_gen.__next__
        cu_next = cu_gen.__next__
        agu_p.wake = cu_p.wake = 0
        max_cycles = cfg.max_cycles
        pipelining = cfg.pipeline_window
        # pipeline windows subsume the quiescent slice-window grant
        windowing = cfg.batch_window or pipelining
        units = evq.units

        now = 0
        while True:
            # --- slice phase (AGU then CU, as in the reference model) ---
            # (the two proc blocks are deliberately duplicated: this loop
            #  runs per executed cycle and per-iteration overhead counts)
            if agu_p.wake <= now:
                agu_p.wake = INF
                if not agu_p.done:
                    park = agu_p.park
                    if park is not None:
                        # deregister before re-checking the condition
                        waiters = (park[1].push_waiters
                                   if park[0] == PARK_PUSH
                                   else park[1].pop_waiters)
                        if agu_p in waiters:
                            waiters.remove(agu_p)
                        agu_p.blocked_on = ""  # re-set if it parks again
                    agu_p._now = now
                    try:
                        agu_next()
                    except StopIteration:
                        pass
                    t2 = agu_p._now  # window read-back: cycles it consumed
                    if t2 > now:
                        res.window_cycles += t2 - now
                        now = t2
                    agu_p.window_end = 0
                    if not agu_p.done:
                        park = agu_p.park
                        if park is None:
                            agu_p.wake = now + 1
                        elif park[0] == PARK_PUSH:
                            park[1].push_waiters.append(agu_p)
                        else:
                            fifo = park[1]
                            fifo.pop_waiters.append(agu_p)
                            if fifo.q:  # head not yet arrived: timed wake
                                arr = fifo.q[0][0]
                                evq.schedule(agu_p,
                                             arr if arr > now else now + 1)
            if cu_p.wake <= now:
                cu_p.wake = INF
                if not cu_p.done:
                    park = cu_p.park
                    if park is not None:
                        waiters = (park[1].push_waiters
                                   if park[0] == PARK_PUSH
                                   else park[1].pop_waiters)
                        if cu_p in waiters:
                            waiters.remove(cu_p)
                        cu_p.blocked_on = ""  # re-set if it parks again
                    cu_p._now = now
                    try:
                        cu_next()
                    except StopIteration:
                        pass
                    t2 = cu_p._now  # window read-back: cycles it consumed
                    if t2 > now:
                        res.window_cycles += t2 - now
                        now = t2
                    cu_p.window_end = 0
                    if not cu_p.done:
                        park = cu_p.park
                        if park is None:
                            cu_p.wake = now + 1
                        elif park[0] == PARK_PUSH:
                            park[1].push_waiters.append(cu_p)
                        else:
                            fifo = park[1]
                            fifo.pop_waiters.append(cu_p)
                            if fifo.q:  # head not yet arrived: timed wake
                                arr = fifo.q[0][0]
                                evq.schedule(cu_p,
                                             arr if arr > now else now + 1)

            # --- DU phase (each LSQ, sorted-array order; tick schedules
            #     its own next wakeup).  Single-LSQ machines — all but one
            #     of the paper's workloads — take the direct path ---
            if lsq0 is not None:
                if lsq0.wake <= now:
                    lsq0.wake = INF
                    lsq0.tick(now)
            else:
                for lsq in lsq_list:
                    if lsq.wake <= now:
                        lsq.wake = INF
                        lsq.tick(now)

            # --- termination / time jump ---
            if agu_p.done and cu_p.done:
                for l in lsq_list:
                    if not l.drained():
                        break
                else:
                    res.cycles = now
                    return res

            # inlined EventQueue.next_two (this is the per-iteration hot
            # path; the method is the documented spec)
            w1 = w2 = INF
            u1 = None
            for u in units:
                uw = u.wake
                if uw < w1:
                    w2 = w1
                    w1 = uw
                    u1 = u
                elif uw < w2:
                    w2 = uw
            if u1 is None:
                raise Deadlock(self._diag(now))
            if w1 > max_cycles:
                raise Deadlock("cycle budget exceeded: " + self._diag(w1))
            if pipelining and w2 == w1:
                # >=2 units runnable at w1: the steady-state pipeline
                # pattern.  Grant the whole runnable set the stretch and
                # advance it in the steady regime loop; control returns
                # here (phases above no-op: every wake > last) when a gap
                # opens or the set thins to one unit.
                res.pipeline_grants += 1
                last = self._steady(w1)
                res.pipeline_cycles += last - w1
                now = last
                continue
            if windowing and (u1 is agu_p or u1 is cu_p):
                # sole runnable unit before w2 is a slice process: grant it
                # the window [w1, w2) — capped so a runaway compute loop
                # still trips the cycle budget above on the next scan
                end = w2 if w2 <= max_cycles else max_cycles + 1
                if end > w1 + 1:
                    u1.window_end = end
                    res.window_grants += 1
            elif pipelining:
                # sole runnable unit before w2 is an LSQ: grant it the
                # window [w1, w2) and advance it with the compiled
                # run-tick (same cap as the slice grant)
                end = w2 if w2 <= max_cycles else max_cycles + 1
                if end > w1 + 1:
                    res.pipeline_grants += 1
                    u1.wake = INF
                    last = u1.tick_run(w1, end, agu_p, cu_p)
                    res.pipeline_cycles += last - w1
                    now = last
                    continue
            now = w1

    def _steady(self, now: int) -> int:
        """Steady-regime loop: the multi-unit pipeline window.

        Entered when the wakeup scan shows >= 2 units runnable at ``now``
        (``w2 == w1`` — the shape neither the quiescent slice window nor
        the LSQ run-tick can cover).  Executes the reference AGU → CU →
        DU phase order cycle by cycle, staying in the regime while the
        runnable set keeps >= 2 members each consecutive cycle, without
        the outer loop's per-cycle orchestration: no grant scan, no
        termination scan, no window read-back (no slice window can be
        granted inside the regime, so ``_now`` never runs ahead and
        ``window_end`` stays 0).  Returns the last executed cycle; every
        unit's ``wake`` is then > that cycle, so the outer loop's phase
        blocks no-op and control lands on its termination check and scan.

        The slice-phase blocks below are the third and fourth copies of
        ``_run``'s deliberately duplicated pair (per-cycle call overhead
        counts in both loops).  Any change to park/resume semantics must
        be applied to ALL FOUR copies — _run:AGU, _run:CU, here:AGU,
        here:CU — or the engines drift apart in ways only the deadlock
        diagnostics reveal.
        """
        agu_p, cu_p = self.agu_p, self.cu_p
        agu_next = self._agu_gen.__next__
        cu_next = self._cu_gen.__next__
        lsq_list = self._lsq_list
        lsq0 = lsq_list[0] if len(lsq_list) == 1 else None
        max_cycles = self.cfg.max_cycles
        while True:
            # --- slice phase (AGU then CU, as in the reference model) ---
            if agu_p.wake <= now:
                agu_p.wake = INF
                if not agu_p.done:
                    park = agu_p.park
                    if park is not None:
                        waiters = (park[1].push_waiters
                                   if park[0] == PARK_PUSH
                                   else park[1].pop_waiters)
                        if agu_p in waiters:
                            waiters.remove(agu_p)
                        agu_p.blocked_on = ""  # re-set if it parks again
                    agu_p._now = now
                    try:
                        agu_next()
                    except StopIteration:
                        pass
                    if not agu_p.done:
                        park = agu_p.park
                        if park is None:
                            agu_p.wake = now + 1
                        elif park[0] == PARK_PUSH:
                            park[1].push_waiters.append(agu_p)
                        else:
                            fifo = park[1]
                            fifo.pop_waiters.append(agu_p)
                            if fifo.q:  # head not yet arrived: timed wake
                                arr = fifo.q[0][0]
                                t = arr if arr > now else now + 1
                                if t < agu_p.wake:
                                    agu_p.wake = t
            if cu_p.wake <= now:
                cu_p.wake = INF
                if not cu_p.done:
                    park = cu_p.park
                    if park is not None:
                        waiters = (park[1].push_waiters
                                   if park[0] == PARK_PUSH
                                   else park[1].pop_waiters)
                        if cu_p in waiters:
                            waiters.remove(cu_p)
                        cu_p.blocked_on = ""  # re-set if it parks again
                    cu_p._now = now
                    try:
                        cu_next()
                    except StopIteration:
                        pass
                    if not cu_p.done:
                        park = cu_p.park
                        if park is None:
                            cu_p.wake = now + 1
                        elif park[0] == PARK_PUSH:
                            park[1].push_waiters.append(cu_p)
                        else:
                            fifo = park[1]
                            fifo.pop_waiters.append(cu_p)
                            if fifo.q:  # head not yet arrived: timed wake
                                arr = fifo.q[0][0]
                                t = arr if arr > now else now + 1
                                if t < cu_p.wake:
                                    cu_p.wake = t

            # --- DU phase ---
            nxt = now + 1
            if lsq0 is not None:
                if lsq0.wake <= now:
                    lsq0.wake = INF
                    lsq0.tick(now)
                lw = lsq0.wake
                aw = agu_p.wake
                cw = cu_p.wake
                if aw < cw:
                    a0, a1 = aw, cw
                else:
                    a0, a1 = cw, aw
                if lw < a0:
                    w1, w2 = lw, a0
                elif lw < a1:
                    w1, w2 = a0, lw
                else:
                    w1, w2 = a0, a1
            else:
                w1 = w2 = INF
                for lsq in lsq_list:
                    if lsq.wake <= now:
                        lsq.wake = INF
                        lsq.tick(now)
                    lw = lsq.wake
                    if lw < w1:
                        w2 = w1
                        w1 = lw
                    elif lw < w2:
                        w2 = lw
                aw = agu_p.wake
                if aw < w1:
                    w2 = w1
                    w1 = aw
                elif aw < w2:
                    w2 = aw
                cw = cu_p.wake
                if cw < w1:
                    w2 = w1
                    w1 = cw
                elif cw < w2:
                    w2 = cw

            # --- regime boundary.  Stay while the next cycle keeps >= 2
            #     units runnable (the steady pattern); ride solo cycles
            #     whose follow-up wake is one cycle out (no window could
            #     be granted there anyway — a grant needs w2 > w1 + 1);
            #     jump idle gaps whose far side resumes the steady
            #     pattern; advance a grantable sole-runnable LSQ with the
            #     compiled run-tick in place.  Hand back to the outer
            #     loop for slice-window grants, terminal states, and the
            #     cycle budget ---
            if nxt > max_cycles:
                return now  # outer scan trips the cycle budget
            if aw > nxt and cw > nxt and agu_p.done and cu_p.done:
                # drain phase: the outer loop's termination check runs
                # between cycles and records the cycle count there, so
                # the regime must not coast past the drain point
                for lsq in lsq_list:
                    if not lsq.drained():
                        break
                else:
                    return now
            if w1 != nxt:
                if w2 == w1 and w1 <= max_cycles:
                    now = w1  # gap, then >= 2 units runnable: jump inside
                    continue
                return now  # gap: outer loop jumps time (or terminates)
            if w2 > nxt + 1:
                if lsq0 is not None and lsq0.wake == nxt:
                    # sole-runnable LSQ: compiled run-tick, in place
                    lsq0.wake = INF
                    end = w2 if w2 <= max_cycles else max_cycles + 1
                    now = lsq0.tick_run(nxt, end, agu_p, cu_p)
                    continue  # phase guards no-op; boundary recomputes
                return now  # sole runnable slice: outer window grant
            now = nxt

    def _diag(self, now) -> str:
        lines = [f"deadlock at cycle {now}:",
                 f"  AGU done={self.agu_p.done} "
                 f"blocked={self.agu_p.blocked_on!r}",
                 f"  CU  done={self.cu_p.done} "
                 f"blocked={self.cu_p.blocked_on!r}"]
        for a, l in self.lsqs.items():
            lines.append(
                f"  LSQ[{a}] loads={len(l.loads)} stores={len(l.stores)}"
                f" req={len(l.req)} ldval={len(l.ld_val)}"
                f" stval={len(l.st_val)} resp={len(l.agu_resp)}")
        return "\n".join(lines)


def run_dae(agu: Function, cu: Function, memory: Dict[str, np.ndarray],
            decoupled: Set[str], params: Optional[Dict[str, Any]] = None,
            cfg: Optional[MachineConfig] = None) -> MachineResult:
    """Simulate the decoupled pair against ``memory`` (mutated in place).

    Decoupled arrays live behind their LSQ; other arrays are private per
    slice (each slice keeps its own coherent copy, see decouple()).  On
    return, ``memory`` holds the DU state for decoupled arrays and the CU
    state for the rest.
    """
    return Machine(agu, cu, memory, decoupled, params, cfg).run()
