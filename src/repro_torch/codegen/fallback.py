"""Coupled untimed execution — the backend's always-correct fallback.

When the stream schedule is illegal (value-dependent AGU, an op outside
the emitters' subset, a dynamic contract violation) the slices still
*execute*: this module runs AGU and CU as cooperating interpreters over
unbounded per-array channels, with none of the cycle accounting of
:mod:`repro.core.sim`.  It preserves exactly the request-order semantics
the LSQ implements:

* per array, store values pair with store addresses in issue order and
  commit eagerly as soon as both halves exist (in-order commit);
* a load's value is read at consume time, when — by the per-array
  FIFO-order invariant the transforms maintain — every older store has
  already committed and no younger store has; load addresses clamp, and a
  poisoned store commits nothing;
* an AGU-side ``sync`` load blocks while any *unvalued* older store to
  the same (raw) address is pending — the Fig. 1b round trip, resolved by
  letting the CU run.

Scheduling is round-robin with a global progress counter; a full round
with no channel event means the slice pair is deadlocked, which is
reported as :class:`~repro.codegen.analysis.CodegenError` rather than
looping forever.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Set

import numpy as np

from ..core.interp import eval_binop
from ..core.ir import Function
from ..core.sim.base import POISON
from ..resilience import faults
from .analysis import CodegenError


class _Chan:
    """Per-decoupled-array channel state (requests, values, memory)."""

    __slots__ = ("name", "mem", "cast", "hi", "ld_addrs", "st_addrs",
                 "st_vals", "pending_st", "committed", "poisoned",
                 "consumed")

    def __init__(self, name: str, mem: np.ndarray):
        self.name = name
        self.mem = mem.tolist()
        self.cast = mem.dtype.type
        self.hi = len(self.mem) - 1
        self.ld_addrs: deque = deque()   # requested, not yet consumed (raw)
        self.st_addrs: deque = deque()   # requested, not yet valued
        self.st_vals: deque = deque()    # produced, not yet addressed
        self.pending_st: Dict[int, int] = {}  # raw addr -> unvalued count
        self.committed = 0
        self.poisoned = 0
        self.consumed = 0

    def pump(self) -> None:
        """Commit every store whose address and value both arrived."""
        while self.st_addrs and self.st_vals:
            a = self.st_addrs.popleft()
            n = self.pending_st[a] - 1
            if n:
                self.pending_st[a] = n
            else:
                del self.pending_st[a]
            v = self.st_vals.popleft()
            if v is POISON:
                self.poisoned += 1
            else:
                if not (0 <= a <= self.hi):
                    raise CodegenError(
                        f"non-poisoned store out of bounds: "
                        f"{self.name}[{a}]")
                self.mem[a] = self.cast(v).item()
                self.committed += 1

    def read(self, addr: int) -> Any:
        a = 0 if addr < 0 else (self.hi if addr > self.hi else addr)
        return self.mem[a]


def _v(env: Dict[str, Any], a: Any) -> Any:
    return env[a] if isinstance(a, str) else a


def _slice_gen(name: str, fn: Function, params: Dict[str, Any],
               local: Dict[str, np.ndarray], chans: Dict[str, _Chan],
               counter, max_steps: int):
    """Interpret one slice; yields whenever blocked on a channel."""
    env: Dict[str, Any] = dict(params)
    regs: Dict[str, Any] = {}
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
                        break
                else:
                    raise CodegenError(
                        f"{name}: phi {p.dest} in {cur}: "
                        f"no incoming for {prev}")
            env.update(vals)

        for instr in blk.body:
            steps += 1
            if steps > max_steps:
                raise CodegenError(f"{name}: step budget exceeded")
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
                arr = local[instr.array]
                a = int(_v(env, instr.args[0]))
                a = min(max(a, 0), len(arr) - 1)
                env[instr.dest] = arr[a].item()
            elif op == "store":
                arr = local[instr.array]
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
                ch = chans[instr.array]
                a = int(_v(env, instr.args[0]))
                ch.ld_addrs.append(a)
                counter[0] += 1
                if instr.meta.get("sync"):
                    # block while an unvalued older store may alias
                    while a in ch.pending_st:
                        yield "sync"
                    env[instr.dest] = ch.read(a)
            elif op == "send_st":
                ch = chans[instr.array]
                a = int(_v(env, instr.args[0]))
                ch.st_addrs.append(a)
                ch.pending_st[a] = ch.pending_st.get(a, 0) + 1
                counter[0] += 1
                ch.pump()
            elif op == "consume_ld":
                ch = chans[instr.array]
                while not ch.ld_addrs:
                    yield "consume"
                env[instr.dest] = ch.read(ch.ld_addrs.popleft())
                ch.consumed += 1
                counter[0] += 1
            elif op == "produce_st":
                ch = chans[instr.array]
                ch.st_vals.append(_v(env, instr.args[0]))
                counter[0] += 1
                ch.pump()
            elif op == "poison_st":
                pr = instr.meta.get("pred_reg")
                if pr is None or regs.get(pr, 0):
                    ch = chans[instr.array]
                    ch.st_vals.append(POISON)
                    counter[0] += 1
                    ch.pump()
            elif op == "print":
                pass
            else:
                raise CodegenError(f"{name}: cannot execute {op}")

        term = blk.term
        if term.kind == "ret":
            return
        if not blk.synthetic:
            prev = cur
        if term.kind == "br":
            cur = term.targets[0]
        else:
            cur = term.targets[0 if bool(env[term.cond]) else 1]


def run_coupled(compiled, memory: Dict[str, np.ndarray],
                decoupled: Set[str], params: Optional[Dict[str, Any]] = None,
                max_steps: int = 2_000_000) -> Dict[str, Any]:
    """Execute the slice pair coupled; mutates ``memory`` in place.

    Same memory contract as :func:`repro.core.machine.run_dae`: decoupled
    arrays end in channel (DU) state, the rest in CU state; the AGU works
    on private copies of the non-decoupled arrays.
    """
    params = dict(params or {})
    faults.inject("codegen.coupled")
    chans = {a: _Chan(a, memory[a]) for a in sorted(decoupled)}
    agu_local = {a: memory[a].copy() for a in memory if a not in decoupled}
    # the CU works on private copies too: a mid-run failure (deadlock,
    # step budget, unknown op) after some local stores must leave the
    # caller's memory untouched — write back only on success below
    cu_local = {a: memory[a].copy() for a in memory if a not in decoupled}
    counter = [0]

    gens = [
        _slice_gen("AGU", compiled.agu, params, agu_local, chans, counter,
                   max_steps),
        _slice_gen("CU", compiled.cu, params, cu_local, chans, counter,
                   max_steps),
    ]
    done = [False, False]
    while not all(done):
        before = counter[0]
        done_before = list(done)
        for i, g in enumerate(gens):
            if done[i]:
                continue
            try:
                next(g)
            except StopIteration:
                done[i] = True
        if counter[0] == before and done == done_before:
            live = [("AGU", "CU")[i] for i in range(2) if not done[i]]
            raise CodegenError(
                f"coupled execution deadlocked ({'/'.join(live)} "
                f"blocked, no channel progress)")

    for a, ch in chans.items():
        memory[a][:] = ch.mem
    for a, arr in cu_local.items():
        memory[a][:] = arr
    return {
        "stores_committed": sum(c.committed for c in chans.values()),
        "stores_poisoned": sum(c.poisoned for c in chans.values()),
        "loads_consumed": sum(c.consumed for c in chans.values()),
        "ld_leftover": sum(len(c.ld_addrs) for c in chans.values()),
        "st_leftover": sum(len(c.st_addrs) + len(c.st_vals)
                           for c in chans.values()),
    }
