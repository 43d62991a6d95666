"""Sequential reference interpreter — the oracle for every transform.

Executes an (untransformed) IR function directly against numpy arrays and
records the dynamic *store trace* [(array, idx, value), ...] and *load trace*.
Lemma 6.1's executable form: the non-poisoned store sequence produced by the
transformed AGU/CU pair (run on :mod:`repro.core.machine`) must equal the
store trace recorded here, and final memory must match exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .ir import Function, Instr

_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "//": lambda a, b: int(a) // int(b) if b else 0,
    "%": lambda a, b: int(a) % int(b) if b else 0,
    "<": lambda a, b: int(a < b),
    "<=": lambda a, b: int(a <= b),
    ">": lambda a, b: int(a > b),
    ">=": lambda a, b: int(a >= b),
    "==": lambda a, b: int(a == b),
    "!=": lambda a, b: int(a != b),
    "&": lambda a, b: int(bool(a) and bool(b)),
    "|": lambda a, b: int(bool(a) or bool(b)),
    "min": min,
    "max": max,
    "^": lambda a, b: int(a) ^ int(b),
}


def eval_binop(op: str, a: Any, b: Any) -> Any:
    return _BINOPS[op](a, b)


@dataclass
class Trace:
    stores: List[Tuple[str, int, Any]] = field(default_factory=list)
    loads: List[Tuple[str, int, Any]] = field(default_factory=list)
    blocks: List[str] = field(default_factory=list)
    instr_count: int = 0


class InterpError(RuntimeError):
    pass


def run(fn: Function, memory: Dict[str, np.ndarray],
        params: Optional[Dict[str, Any]] = None,
        max_steps: int = 2_000_000) -> Trace:
    """Execute ``fn`` sequentially, mutating ``memory`` in place.

    Functions in the sequential op set run through the compiled fast path
    (:func:`repro_torch.core.sim.compile.compile_interp` — bit-identical traces
    and final memory); DAE ops fall through to the interpreter below,
    which rejects them with the usual InterpError.
    """
    from .sim.compile import compile_interp
    fast = compile_interp(fn)
    if fast is not None:
        return fast(memory, dict(params or {}), max_steps, Trace())
    env: Dict[str, Any] = dict(params or {})
    regs: Dict[str, Any] = {}
    trace = Trace()

    cur = fn.entry
    prev: Optional[str] = None
    steps = 0
    while True:
        blk = fn.blocks[cur]
        trace.blocks.append(cur)

        # phis evaluate simultaneously on entry, based on dynamic predecessor
        if blk.phis:
            vals = {}
            for p in blk.phis:
                for (pb, v) in p.args:
                    if pb == prev:
                        vals[p.dest] = env[v]
                        break
                else:
                    raise InterpError(
                        f"phi {p.dest} in {cur} has no incoming for pred {prev}")
            env.update(vals)

        for instr in blk.body:
            steps += 1
            if steps > max_steps:
                raise InterpError("interpreter step budget exceeded")
            _exec(instr, env, regs, memory, trace)
        trace.instr_count = steps

        term = blk.term
        if term.kind == "ret":
            return trace
        if not blk.synthetic:
            prev = cur  # synthetic (poison) blocks are phi-transparent
        if term.kind == "br":
            cur = term.targets[0]
        else:  # cbr
            taken = bool(env[term.cond])
            cur = term.targets[0 if taken else 1]


def _exec(instr: Instr, env: Dict[str, Any], regs: Dict[str, Any],
          memory: Dict[str, np.ndarray], trace: Trace) -> None:
    op = instr.op
    if op == "const":
        env[instr.dest] = instr.args[0]
    elif op == "bin":
        o, a, b = instr.args
        env[instr.dest] = eval_binop(o, _val(env, a), _val(env, b))
    elif op == "select":
        c, t, f = instr.args
        env[instr.dest] = _val(env, t) if _val(env, c) else _val(env, f)
    elif op == "load":
        idx = int(_val(env, instr.args[0]))
        val = memory[instr.array][idx].item()
        env[instr.dest] = val
        trace.loads.append((instr.array, idx, val))
    elif op == "store":
        idx = int(_val(env, instr.args[0]))
        val = _val(env, instr.args[1])
        memory[instr.array][idx] = val
        trace.stores.append((instr.array, idx, val))
    elif op == "setreg":
        regs[instr.args[0]] = (instr.meta["imm"] if "imm" in instr.meta
                               else _val(env, instr.args[1]))
    elif op == "getreg":
        env[instr.dest] = regs.get(instr.args[0], 0)
    elif op == "print":  # debugging aid
        pass
    else:
        raise InterpError(f"sequential interpreter cannot execute {op}; "
                          f"DAE ops run on repro.core.machine")


def _val(env: Dict[str, Any], a: Any) -> Any:
    return env[a] if isinstance(a, str) else a
