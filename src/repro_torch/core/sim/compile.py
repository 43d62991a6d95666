"""Slice-to-Python compiler: lowers an IR slice to a native generator.

The interpreted :class:`~repro_torch.core.sim.units.SliceProc` pays per-executed
instruction for string dispatch, ``env`` dict traffic, and operand
resolution.  This module lowers a slice :class:`~repro_torch.core.ir.Function`
to Python source once per simulation — SSA values become Python locals,
binops are inlined, blocks become an ``if/elif`` dispatch over integer
labels, and phi nodes become parallel tuple assignments selected by the
dynamic predecessor — then ``exec``-compiles it into a generator with the
exact yield discipline of the interpreted path:

* one ``yield`` per simulated cycle, resetting the issue ``budget`` to
  ``width`` (cost-1 ops decrement it; ``const``/``getreg``/``setreg`` are
  free, and a predicated-off ``poison_st`` refunds its slot);
* a blocked FIFO op sets ``self.park``/``self.blocked_on`` before each
  blocked-cycle yield and re-checks its condition on resume, so the
  event-driven machine can skip the blocked cycles wholesale;
* **batch windows** — the generator mirrors the machine clock in a local
  ``_clk`` (synced with ``self._now`` around every yield).  When the
  machine grants a window (``self.window_end > _clk + 1``: every other
  unit provably quiet until then, see :mod:`repro_torch.core.sim.events`), a
  cycle that would otherwise be a bare yield is consumed locally —
  ``_clk += 1`` — and a whole budget-overflow run of private ops advances
  in one arithmetic step.  A parked pop may jump ``_clk`` straight to the
  head's arrival cycle if it lands inside the window.  Every FIFO
  push/pop clamps the local window end to the woken LSQ's new ``wake``,
  which is what keeps the quiescence premise true for the rest of the
  window; cycle counts and all architectural effects stay bit-identical.

Cycle counts and architectural side effects are bit-identical to the
interpreted generator (and therefore to the cycle-stepped reference model);
``tests/test_sim_equivalence.py`` holds both paths to that bar.  A slice
containing an op this compiler does not know falls back to the interpreted
generator (``compile_slice`` returns None).

The same lowering serves two more callers: :func:`compile_sta` (the STA
baseline's static schedule) and :func:`compile_interp`, the fast path of
:func:`repro_torch.core.interp.run`.  ``_BINOP_EXPR``, ``_Namer`` and
``_compile_ns`` are shared with the codegen emitters
(:mod:`repro_torch.codegen.emit`).
"""
from __future__ import annotations

from typing import Dict, List

from ..ir import Function

# binop → inline Python expression, mirroring interp._BINOPS exactly
_BINOP_EXPR = {
    "+": "({a} + {b})",
    "-": "({a} - {b})",
    "*": "({a} * {b})",
    "//": "(int({a}) // int({b}) if {b} else 0)",
    "%": "(int({a}) % int({b}) if {b} else 0)",
    "<": "int({a} < {b})",
    "<=": "int({a} <= {b})",
    ">": "int({a} > {b})",
    ">=": "int({a} >= {b})",
    "==": "int({a} == {b})",
    "!=": "int({a} != {b})",
    "&": "int(bool({a}) and bool({b}))",
    "|": "int(bool({a}) or bool({b}))",
    "min": "min({a}, {b})",
    "max": "max({a}, {b})",
    "^": "(int({a}) ^ int({b}))",
}

_KNOWN_OPS = frozenset([
    "const", "bin", "select", "load", "store", "setreg", "getreg",
    "send_ld", "send_st", "consume_ld", "produce_st", "poison_st", "print",
])

_FREE_OPS = frozenset(["const", "getreg", "setreg"])

# ops with no cross-unit effects: safe to reorder against cycle yields
# within a basic block (see the budget-batching comment in _compile_slice)
_PRIVATE_OPS = frozenset(["const", "bin", "select", "load", "store",
                          "setreg", "getreg", "print"])


class _Namer:
    """IR names → unique valid Python identifiers."""

    def __init__(self) -> None:
        self.map: Dict[str, str] = {}

    def __call__(self, name: str) -> str:
        v = self.map.get(name)
        if v is None:
            v = f"v{len(self.map)}"
            self.map[name] = v
        return v


_CODE_CACHE: Dict[str, object] = {}  # source → compiled code object
_CODE_CACHE_MAX = 512


def _compile_ns(src: str, tag: str, ns: Dict[str, object]):
    """Compile ``src`` (via the shared code cache) and exec into ``ns``."""
    code = _CODE_CACHE.get(src)
    if code is None:
        if len(_CODE_CACHE) >= _CODE_CACHE_MAX:
            _CODE_CACHE.clear()
        code = compile(src, tag, "exec")
        _CODE_CACHE[src] = code
    exec(code, ns)
    return ns


def compile_slice(fn: Function):
    """Lower ``fn`` to a generator factory ``make(self) -> generator``.

    Returns None if the slice uses an op outside the known set (caller
    falls back to the interpreted generator).  The factory is memoised on
    the Function (callers must not mutate a Function after first running
    it — the compile pipeline never does), and compiled code objects are
    shared across structurally identical slices via a source-keyed cache
    (e.g. sweep benchmarks re-simulating one program many times).
    """
    try:
        return fn._sim_slice_make  # type: ignore[attr-defined]
    except AttributeError:
        pass
    make = _compile_slice(fn)
    fn._sim_slice_make = make  # type: ignore[attr-defined]
    return make


def _compile_slice(fn: Function):
    for blk in fn.blocks.values():
        for instr in blk.body:
            if instr.op not in _KNOWN_OPS:
                return None
            if instr.op == "bin" and instr.args[0] not in _BINOP_EXPR:
                return None

    sym = _Namer()
    blk_id = {name: i for i, name in enumerate(fn.blocks)}
    lines: List[str] = []
    emit = lines.append

    def val(a) -> str:
        """Operand: IR name → mangled local, literal → repr."""
        return sym(a) if isinstance(a, str) else repr(a)

    # ---- prologue ------------------------------------------------------
    emit("def _make(self):")
    emit("    _params = self.env")
    emit("    _regs = self.regs")
    emit("    _POISON = __POISON__")
    emit("    W = self.cfg.width")
    local_arrays = sorted({i.array for b in fn.blocks.values()
                           for i in b.body if i.op in ("load", "store")})
    for a in local_arrays:
        # plain-list mirror of the slice-private array (scalar access is
        # several times cheaper than numpy); flushed back at ret
        emit(f"    _loc_{sym(a)} = self.local[{a!r}].tolist()")
        emit(f"    _cast_{sym(a)} = self.local[{a!r}].dtype.type")
        emit(f"    _hi_{sym(a)} = len(_loc_{sym(a)}) - 1")
    fifo_arrays = sorted({i.array for b in fn.blocks.values()
                          for i in b.body
                          if i.op in ("send_ld", "send_st", "consume_ld",
                                      "produce_st", "poison_st")})
    # FIFO interactions are inlined against the fixed wiring topology:
    # req/st_val are pushed only by slices and popped only by the LSQ (so
    # a slice push just appends and lowers the LSQ's wake; nothing ever
    # parks waiting to pop them), ld_val/agu_resp the other way around.
    for a in fifo_arrays:
        s = sym(a)
        emit(f"    _lsq_{s} = self.lsqs[{a!r}]")
        emit(f"    _req_{s} = _lsq_{s}.req")
        emit(f"    _reqq_{s} = _req_{s}.q")
        emit(f"    _reqcap_{s} = _req_{s}.depth")
        emit(f"    _reqlat_{s} = _req_{s}.lat")
        emit(f"    _ldv_{s} = _lsq_{s}.ld_val")
        emit(f"    _ldvq_{s} = _ldv_{s}.q")
        emit(f"    _resp_{s} = _lsq_{s}.agu_resp")
        emit(f"    _respq_{s} = _resp_{s}.q")
        emit(f"    _stv_{s} = _lsq_{s}.st_val")
        emit(f"    _stvq_{s} = _stv_{s}.q")
        emit(f"    _stvcap_{s} = _stv_{s}.depth")
        emit(f"    _stvlat_{s} = _stv_{s}.lat")
        emit(f"    _pkpushreq_{s} = (1, _req_{s})")
        emit(f"    _pkpushstv_{s} = (1, _stv_{s})")
        emit(f"    _pkpopldv_{s} = (2, _ldv_{s})")
        emit(f"    _pkpopresp_{s} = (2, _resp_{s})")
    # every SSA name starts as its param value, or None (mirrors env.get)
    emit("    _Wm1 = W - 1")
    emit("    def run():")
    emit("        budget = W")
    # local mirrors of the machine clock and the granted window end; kept
    # in sync with self._now / self.window_end around every yield
    emit("        _clk = self._now")
    emit("        _wend = self.window_end")

    # collect all names referenced anywhere so locals always exist
    all_names = set()
    for blk in fn.blocks.values():
        for p in blk.phis:
            all_names.add(p.dest)
            all_names.update(v for (_, v) in p.args)
        for i in blk.body:
            if i.dest:
                all_names.add(i.dest)
            all_names.update(i.uses())
        if blk.term is not None and blk.term.kind == "cbr":
            all_names.add(blk.term.cond)
    for name in sorted(all_names):
        emit(f"        {sym(name)} = _params.get({name!r})")

    emit(f"        _blk = {blk_id[fn.entry]}")
    emit("        _prev = -1")
    emit("        while True:")

    # ---- blocks --------------------------------------------------------
    first = True
    for bname, blk in fn.blocks.items():
        bid = blk_id[bname]
        kw = "if" if first else "elif"
        first = False
        emit(f"            {kw} _blk == {bid}:")
        body: List[str] = []
        ind = "                "

        if blk.phis:
            preds = []
            for p in blk.phis:
                for (pb, _) in p.args:
                    if pb not in preds:
                        preds.append(pb)
            kw2 = "if"
            for pb in preds:
                dests, srcs = [], []
                for p in blk.phis:
                    for (ppb, v) in p.args:
                        if ppb == pb:
                            dests.append(sym(p.dest))
                            srcs.append(sym(v))
                            break
                    else:
                        # this phi has no incoming for pb: dynamic error
                        dests.append(sym(p.dest))
                        srcs.append(f"_phi_err({p.dest!r}, {bname!r}, _prev)")
                body.append(f"{ind}{kw2} _prev == {blk_id.get(pb, -2)}:")
                body.append(f"{ind}    {', '.join(dests)} = "
                            f"{', '.join(srcs)}")
                kw2 = "elif"
            body.append(f"{ind}else:")
            body.append(f"{ind}    _phi_err({blk.phis[0].dest!r}, "
                        f"{bname!r}, _prev)")

        # Runs of private ops (compute, local memory, registers) are
        # invisible to the other units, so their per-instruction budget
        # checks batch into one adjustment + yield loop after the run —
        # same cycle count, same budget value at every FIFO op (the only
        # externally observable points).  FIFO ops keep the per-op check.
        # Inside a granted window the whole overflow is consumed as one
        # ``_clk`` advance; the yield loop re-reads the window after every
        # machine round trip so a grant that lands mid-run still batches
        # the remaining cycles.
        pending_cost = 0

        def yield_sync(ind):
            """One machine round trip with the _clk/_wend sync protocol."""
            body.append(f"{ind}self._now = _clk")
            body.append(f"{ind}yield")
            body.append(f"{ind}_clk = self._now")
            body.append(f"{ind}_wend = self.window_end")

        def flush_budget(ind=ind):
            nonlocal pending_cost
            if not pending_cost:
                return
            body.append(f"{ind}budget -= {pending_cost}")
            body.append(f"{ind}if budget < 0:")
            body.append(f"{ind}    _ny = (-budget + _Wm1) // W")
            body.append(f"{ind}    budget += _ny * W")
            body.append(f"{ind}    _adv = _wend - 1 - _clk")
            body.append(f"{ind}    if _adv > 0:")
            body.append(f"{ind}        if _adv >= _ny:")
            body.append(f"{ind}            _clk += _ny")
            body.append(f"{ind}            _ny = 0")
            body.append(f"{ind}        else:")
            body.append(f"{ind}            _clk += _adv")
            body.append(f"{ind}            _ny -= _adv")
            body.append(f"{ind}    while _ny:")
            yield_sync(f"{ind}        ")
            body.append(f"{ind}        _ny -= 1")
            body.append(f"{ind}        _adv = _wend - 1 - _clk")
            body.append(f"{ind}        if _adv > 0 and _ny:")
            body.append(f"{ind}            if _adv >= _ny:")
            body.append(f"{ind}                _clk += _ny")
            body.append(f"{ind}                _ny = 0")
            body.append(f"{ind}            else:")
            body.append(f"{ind}                _clk += _adv")
            body.append(f"{ind}                _ny -= _adv")
            pending_cost = 0

        for instr in blk.body:
            op = instr.op
            if op in _PRIVATE_OPS:
                if op not in _FREE_OPS:
                    pending_cost += 1
            else:
                flush_budget()
                body.append(f"{ind}if budget < 1:")
                body.append(f"{ind}    if _clk + 1 < _wend:")
                body.append(f"{ind}        _clk += 1")
                body.append(f"{ind}    else:")
                yield_sync(f"{ind}        ")
                body.append(f"{ind}    budget = W")
                body.append(f"{ind}budget -= 1")
            if op == "const":
                body.append(f"{ind}{sym(instr.dest)} = {instr.args[0]!r}")
            elif op == "bin":
                o, a, b = instr.args
                expr = _BINOP_EXPR[o].format(a=val(a), b=val(b))
                body.append(f"{ind}{sym(instr.dest)} = {expr}")
            elif op == "select":
                c, t, f = instr.args
                body.append(f"{ind}{sym(instr.dest)} = "
                            f"{val(t)} if {val(c)} else {val(f)}")
            elif op == "load":
                s = sym(instr.array)
                body.append(f"{ind}_a = int({val(instr.args[0])})")
                body.append(f"{ind}if _a < 0: _a = 0")
                body.append(f"{ind}elif _a > _hi_{s}: _a = _hi_{s}")
                body.append(f"{ind}{sym(instr.dest)} = _loc_{s}[_a]")
            elif op == "store":
                s = sym(instr.array)
                body.append(f"{ind}_a = int({val(instr.args[0])})")
                body.append(f"{ind}if 0 <= _a <= _hi_{s}:")
                body.append(f"{ind}    _loc_{s}[_a] = "
                            f"_cast_{s}({val(instr.args[1])}).item()")
            elif op == "setreg":
                if "imm" in instr.meta:
                    body.append(f"{ind}_regs[{instr.args[0]!r}] = "
                                f"{instr.meta['imm']!r}")
                else:
                    body.append(f"{ind}_regs[{instr.args[0]!r}] = "
                                f"{val(instr.args[1])}")
            elif op == "getreg":
                body.append(f"{ind}{sym(instr.dest)} = "
                            f"_regs.get({instr.args[0]!r}, 0)")
            elif op == "send_ld":
                s = sym(instr.array)
                sync = bool(instr.meta.get("sync"))
                body.append(f"{ind}while len(_reqq_{s}) >= _reqcap_{s}:")
                body.append(f"{ind}    self.park = _pkpushreq_{s}")
                body.append(f"{ind}    self.blocked_on = "
                            f"'send_ld {instr.array}'")
                yield_sync(f"{ind}    ")
                body.append(f"{ind}    budget = W")
                body.append(f"{ind}self.park = None")
                body.append(f"{ind}_t = _clk + _reqlat_{s}")
                body.append(f"{ind}_reqq_{s}.append((_t, "
                            f"('ld', int({val(instr.args[0])}), {sync!r})))")
                body.append(f"{ind}if _t < _lsq_{s}.wake: "
                            f"_lsq_{s}.wake = _t")
                body.append(f"{ind}if _lsq_{s}.wake < _wend: "
                            f"_wend = _lsq_{s}.wake")
                if sync:
                    body.append(f"{ind}self.res.sync_waits += 1")
                    body.append(f"{ind}while not (_respq_{s} and "
                                f"_respq_{s}[0][0] <= _clk):")
                    body.append(f"{ind}    if _respq_{s} and "
                                f"_respq_{s}[0][0] < _wend:")
                    body.append(f"{ind}        _clk = _respq_{s}[0][0]")
                    body.append(f"{ind}        budget = W")
                    body.append(f"{ind}        continue")
                    body.append(f"{ind}    self.park = _pkpopresp_{s}")
                    body.append(f"{ind}    self.blocked_on = "
                                f"'sync_resp {instr.array}'")
                    yield_sync(f"{ind}    ")
                    body.append(f"{ind}    budget = W")
                    body.append(f"{ind}self.park = None")
                    body.append(f"{ind}{sym(instr.dest)} = "
                                f"_respq_{s}.popleft()[1]")
                    body.append(f"{ind}if _clk < _lsq_{s}.wake: "
                                f"_lsq_{s}.wake = _clk")
                    body.append(f"{ind}if _lsq_{s}.wake < _wend: "
                                f"_wend = _lsq_{s}.wake")
            elif op == "send_st":
                s = sym(instr.array)
                body.append(f"{ind}while len(_reqq_{s}) >= _reqcap_{s}:")
                body.append(f"{ind}    self.park = _pkpushreq_{s}")
                body.append(f"{ind}    self.blocked_on = "
                            f"'send_st {instr.array}'")
                yield_sync(f"{ind}    ")
                body.append(f"{ind}    budget = W")
                body.append(f"{ind}self.park = None")
                body.append(f"{ind}_t = _clk + _reqlat_{s}")
                body.append(f"{ind}_reqq_{s}.append((_t, "
                            f"('st', int({val(instr.args[0])}), False)))")
                body.append(f"{ind}if _t < _lsq_{s}.wake: "
                            f"_lsq_{s}.wake = _t")
                body.append(f"{ind}if _lsq_{s}.wake < _wend: "
                            f"_wend = _lsq_{s}.wake")
            elif op == "consume_ld":
                s = sym(instr.array)
                body.append(f"{ind}while not (_ldvq_{s} and "
                            f"_ldvq_{s}[0][0] <= _clk):")
                body.append(f"{ind}    if _ldvq_{s} and "
                            f"_ldvq_{s}[0][0] < _wend:")
                body.append(f"{ind}        _clk = _ldvq_{s}[0][0]")
                body.append(f"{ind}        budget = W")
                body.append(f"{ind}        continue")
                body.append(f"{ind}    self.park = _pkpopldv_{s}")
                body.append(f"{ind}    self.blocked_on = "
                            f"'consume_ld {instr.array}'")
                yield_sync(f"{ind}    ")
                body.append(f"{ind}    budget = W")
                body.append(f"{ind}self.park = None")
                body.append(f"{ind}{sym(instr.dest)} = "
                            f"_ldvq_{s}.popleft()[1]")
                body.append(f"{ind}if _clk < _lsq_{s}.wake: "
                            f"_lsq_{s}.wake = _clk")
                body.append(f"{ind}if _lsq_{s}.wake < _wend: "
                            f"_wend = _lsq_{s}.wake")
            elif op in ("produce_st", "poison_st"):
                s = sym(instr.array)
                if op == "poison_st":
                    pr = instr.meta.get("pred_reg")
                    if pr is not None:
                        body.append(f"{ind}if not _regs.get({pr!r}, 0):")
                        body.append(f"{ind}    budget += 1"
                                    f"  # predicated off: free")
                        ind2 = ind + "else:"
                        body.append(ind2)
                        ind = ind + "    "
                    tok = "_POISON"
                else:
                    tok = val(instr.args[0])
                body.append(f"{ind}while len(_stvq_{s}) >= _stvcap_{s}:")
                body.append(f"{ind}    self.park = _pkpushstv_{s}")
                body.append(f"{ind}    self.blocked_on = "
                            f"'{op} {instr.array}'")
                yield_sync(f"{ind}    ")
                body.append(f"{ind}    budget = W")
                body.append(f"{ind}self.park = None")
                body.append(f"{ind}_t = _clk + _stvlat_{s}")
                body.append(f"{ind}_stvq_{s}.append((_t, {tok}))")
                body.append(f"{ind}if _t < _lsq_{s}.wake: "
                            f"_lsq_{s}.wake = _t")
                body.append(f"{ind}if _lsq_{s}.wake < _wend: "
                            f"_wend = _lsq_{s}.wake")
                ind = "                "
            elif op == "print":
                body.append(f"{ind}pass")

        flush_budget()
        term = blk.term
        if term.kind == "ret":
            for a in local_arrays:  # flush list mirrors back to numpy
                body.append(f"{ind}self.local[{a!r}][:] = _loc_{sym(a)}")
            body.append(f"{ind}self._now = _clk")
            body.append(f"{ind}self.done = True")
            body.append(f"{ind}return")
        else:
            if not blk.synthetic:
                body.append(f"{ind}_prev = {bid}")
            if term.kind == "br":
                body.append(f"{ind}_blk = {blk_id[term.targets[0]]}")
            else:
                body.append(f"{ind}_blk = {blk_id[term.targets[0]]} "
                            f"if {sym(term.cond)} else "
                            f"{blk_id[term.targets[1]]}")
            body.append(f"{ind}if _clk + 1 < _wend:")
            body.append(f"{ind}    _clk += 1  # block boundary in-window")
            body.append(f"{ind}else:")
            body.append(f"{ind}    self._now = _clk")
            body.append(f"{ind}    yield  # block boundary")
            body.append(f"{ind}    _clk = self._now")
            body.append(f"{ind}    _wend = self.window_end")
            body.append(f"{ind}budget = W")
        if not body:
            body.append(f"{ind}pass")
        lines.extend(body)

    emit("            else:")
    emit("                raise RuntimeError("
         "f'{self.name}: bad block id {_blk}')")
    emit("    return run()")

    src = "\n".join(lines)
    from .base import POISON

    def _phi_err(dest, bname, prev):
        raise RuntimeError(f"phi {dest} in {bname}: no incoming for {prev}")

    ns = _compile_ns(src, f"<slice:{fn.name}>",
                     {"__POISON__": POISON, "_phi_err": _phi_err})
    make = ns["_make"]
    make.__source__ = src  # for debugging
    return make


# ---------------------------------------------------------------------------
# STA fast path: the §8.1.1 static-schedule model, lowered the same way
# ---------------------------------------------------------------------------

_STA_OPS = frozenset(["const", "bin", "select", "load", "store",
                      "setreg", "getreg"])


def compile_sta(fn: Function):
    """Lower ``fn`` to ``run(memory, params, cfg) -> MachineResult``.

    Bit-identical to the interpreted ``machine.run_sta`` (same issue-slot
    schedule, same ready-time propagation, same store traces); returns None
    when the function contains an op outside the STA set so the caller
    falls back.  Ready times become ``r_*`` locals (None = "never set",
    mirroring ``ready.get`` defaults), arrays become plain-list mirrors
    flushed back on exit, and ``issue()`` is inlined at each site.
    """
    try:
        return fn._sim_sta_make  # type: ignore[attr-defined]
    except AttributeError:
        pass
    make = _compile_sta(fn)
    fn._sim_sta_make = make  # type: ignore[attr-defined]
    return make


def _compile_sta(fn: Function):
    for blk in fn.blocks.values():
        for instr in blk.body:
            if instr.op not in _STA_OPS:
                return None
            if instr.op == "bin" and instr.args[0] not in _BINOP_EXPR:
                return None

    sym = _Namer()
    blk_id = {name: i for i, name in enumerate(fn.blocks)}
    lines: List[str] = []
    emit = lines.append

    def val(a) -> str:
        return sym(a) if isinstance(a, str) else repr(a)

    def rd(name: str) -> str:
        """ready.get(name, 0.0) as an expression over the r_ local."""
        r = f"r_{sym(name)}"
        return f"(0.0 if {r} is None else {r})"

    def dep_expr(instr) -> str:
        us = instr.uses()
        if not us:
            return "0.0"
        parts = [rd(u) for u in us]
        return parts[0] if len(parts) == 1 else f"max({', '.join(parts)})"

    all_names = set()
    for blk in fn.blocks.values():
        for p in blk.phis:
            all_names.add(p.dest)
            all_names.update(v for (_, v) in p.args)
        for i in blk.body:
            if i.dest:
                all_names.add(i.dest)
            all_names.update(i.uses())
        if blk.term is not None and blk.term.kind == "cbr":
            all_names.add(blk.term.cond)
    arrays = sorted({i.array for b in fn.blocks.values()
                     for i in b.body if i.op in ("load", "store")})

    emit("def _run(memory, _params, cfg):")
    emit("    _res = _MachineResult(cycles=0)")
    emit("    _regs = {}")
    emit("    W = cfg.sta_width")
    emit("    _ml = cfg.mem_lat")
    emit("    _max = cfg.max_cycles")
    emit("    t = 0.0")
    emit("    slots = 0")
    emit("    steps = 0")
    for a in arrays:
        s = sym(a)
        emit(f"    _mem_{s} = memory[{a!r}].tolist()")
        emit(f"    _cast_{s} = memory[{a!r}].dtype.type")
        emit(f"    _hi_{s} = len(_mem_{s}) - 1")
        emit(f"    _lsc_{s} = 0.0")
        emit(f"    _tr_{s} = None")
    for name in sorted(all_names):
        s = sym(name)
        emit(f"    {s} = _params.get({name!r})")
        emit(f"    r_{s} = None")
    emit("    try:")
    emit(f"        _blk = {blk_id[fn.entry]}")
    emit("        _prev = -1")
    emit("        while True:")

    def emit_issue(ind: str, dep: str) -> None:
        """Inline issue(dep): updates t/slots; result is the new t."""
        emit(f"{ind}_dep = {dep}")
        emit(f"{ind}if _dep > t:")
        emit(f"{ind}    t = _dep")
        emit(f"{ind}    slots = 0")
        emit(f"{ind}if slots >= W:")
        emit(f"{ind}    t = t + 1")
        emit(f"{ind}    slots = 0")
        emit(f"{ind}slots += 1")

    first = True
    for bname, blk in fn.blocks.items():
        bid = blk_id[bname]
        kw = "if" if first else "elif"
        first = False
        emit(f"            {kw} _blk == {bid}:")
        ind = "                "
        emitted_any = False

        if blk.phis:
            preds = []
            for p in blk.phis:
                for (pb, _) in p.args:
                    if pb not in preds:
                        preds.append(pb)
            kw2 = "if"
            for pb in preds:
                moves = []
                for p in blk.phis:
                    for (ppb, v) in p.args:
                        if ppb == pb:
                            moves.append((p.dest, v))
                            break
                emit(f"{ind}{kw2} _prev == {blk_id.get(pb, -2)}:")
                # ready updates are sequential (as in the dict loop);
                # env updates are simultaneous (vals then update)
                for (d, v) in moves:
                    emit(f"{ind}    r_{sym(d)} = "
                         f"(t if r_{sym(v)} is None else r_{sym(v)})")
                dests = ", ".join(sym(d) for (d, _) in moves)
                srcs = ", ".join(sym(v) for (_, v) in moves)
                emit(f"{ind}    {dests} = {srcs}")
                kw2 = "elif"
            emitted_any = True

        if blk.body:
            emit(f"{ind}steps += {len(blk.body)}")
            emit(f"{ind}if steps > _max:")
            emit(f"{ind}    raise _Deadlock('STA step budget exceeded')")
            emitted_any = True
        for instr in blk.body:
            op = instr.op
            if op == "const":
                emit(f"{ind}{sym(instr.dest)} = {instr.args[0]!r}")
                emit(f"{ind}r_{sym(instr.dest)} = 0.0")
            elif op == "bin":
                o, a, b = instr.args
                emit_issue(ind, dep_expr(instr))
                expr = _BINOP_EXPR[o].format(a=val(a), b=val(b))
                emit(f"{ind}{sym(instr.dest)} = {expr}")
                emit(f"{ind}r_{sym(instr.dest)} = t + 1")
            elif op == "select":
                c, a, b = instr.args
                emit_issue(ind, dep_expr(instr))
                emit(f"{ind}{sym(instr.dest)} = "
                     f"{val(a)} if {val(c)} else {val(b)}")
                emit(f"{ind}r_{sym(instr.dest)} = t + 1")
            elif op == "load":
                s = sym(instr.array)
                emit_issue(ind, f"max({dep_expr(instr)}, _lsc_{s})")
                emit(f"{ind}_a = int({val(instr.args[0])})")
                emit(f"{ind}if _a < 0: _a = 0")
                emit(f"{ind}elif _a > _hi_{s}: _a = _hi_{s}")
                emit(f"{ind}{sym(instr.dest)} = _mem_{s}[_a]")
                emit(f"{ind}r_{sym(instr.dest)} = t + _ml")
                emit(f"{ind}_res.loads_served += 1")
            elif op == "store":
                s = sym(instr.array)
                emit_issue(ind, dep_expr(instr))
                emit(f"{ind}_a = int({val(instr.args[0])})")
                emit(f"{ind}_val = {val(instr.args[1])}")
                emit(f"{ind}_mem_{s}[_a] = _cast_{s}(_val).item()")
                emit(f"{ind}_lsc_{s} = t + 1")
                emit(f"{ind}_res.stores_committed += 1")
                emit(f"{ind}if _tr_{s} is None:")
                emit(f"{ind}    _tr_{s} = _res.store_trace.setdefault("
                     f"{instr.array!r}, [])")
                emit(f"{ind}_tr_{s}.append((_a, _val))")
            elif op == "setreg":
                if "imm" in instr.meta:
                    emit(f"{ind}_regs[{instr.args[0]!r}] = "
                         f"{instr.meta['imm']!r}")
                else:
                    emit(f"{ind}_regs[{instr.args[0]!r}] = "
                         f"{val(instr.args[1])}")
            elif op == "getreg":
                emit(f"{ind}{sym(instr.dest)} = "
                     f"_regs.get({instr.args[0]!r}, 0)")
                emit(f"{ind}r_{sym(instr.dest)} = t")

        term = blk.term
        if term.kind == "ret":
            rl = ", ".join(f"r_{sym(n)}" for n in sorted(all_names))
            emit(f"{ind}_rs = [_r for _r in ({rl}{',' if all_names else ''}) "
                 f"if _r is not None]")
            emit(f"{ind}_rs.append(t)")
            emit(f"{ind}_res.cycles = int(max(_rs))")
            emit(f"{ind}return _res")
        else:
            if not blk.synthetic:
                emit(f"{ind}_prev = {bid}")
            if term.kind == "br":
                emit(f"{ind}_blk = {blk_id[term.targets[0]]}")
            else:
                emit(f"{ind}_blk = {blk_id[term.targets[0]]} "
                     f"if {sym(term.cond)} else {blk_id[term.targets[1]]}")
            emitted_any = True
        if not emitted_any and term.kind == "ret":
            pass  # ret always emits

    emit("            else:")
    emit("                raise RuntimeError(f'STA: bad block id {_blk}')")
    emit("    finally:")
    for a in arrays:
        s = sym(a)
        emit(f"        memory[{a!r}][:] = _mem_{s}")
    if not arrays:
        emit("        pass")

    src = "\n".join(lines)
    from .base import Deadlock, MachineResult
    ns = _compile_ns(src, f"<sta:{fn.name}>",
                     {"_MachineResult": MachineResult, "_Deadlock": Deadlock})
    make = ns["_run"]
    make.__source__ = src
    return make


# ---------------------------------------------------------------------------
# Sequential-interpreter fast path (the "ref" oracle)
# ---------------------------------------------------------------------------

_INTERP_OPS = frozenset(["const", "bin", "select", "load", "store",
                         "setreg", "getreg", "print"])


def compile_interp(fn: Function):
    """Lower ``fn`` to ``run(memory, params, max_steps, trace) -> Trace``.

    Bit-identical traces (stores, loads, blocks, instr_count) and final
    memory to the interpreted ``interp.run``; returns None when the
    function contains a DAE op (the interpreted path then raises its
    usual InterpError).
    """
    try:
        return fn._sim_interp_make  # type: ignore[attr-defined]
    except AttributeError:
        pass
    make = _compile_interp(fn)
    fn._sim_interp_make = make  # type: ignore[attr-defined]
    return make


def _compile_interp(fn: Function):
    for blk in fn.blocks.values():
        for instr in blk.body:
            if instr.op not in _INTERP_OPS:
                return None
            if instr.op == "bin" and instr.args[0] not in _BINOP_EXPR:
                return None

    sym = _Namer()
    blk_id = {name: i for i, name in enumerate(fn.blocks)}
    bnames = [None] * len(blk_id)
    for name, i in blk_id.items():
        bnames[i] = name
    lines: List[str] = []
    emit = lines.append

    def val(a) -> str:
        return sym(a) if isinstance(a, str) else repr(a)

    all_names = set()
    for blk in fn.blocks.values():
        for p in blk.phis:
            all_names.add(p.dest)
            all_names.update(v for (_, v) in p.args)
        for i in blk.body:
            if i.dest:
                all_names.add(i.dest)
            all_names.update(i.uses())
        if blk.term is not None and blk.term.kind == "cbr":
            all_names.add(blk.term.cond)
    arrays = sorted({i.array for b in fn.blocks.values()
                     for i in b.body if i.op in ("load", "store")})

    emit("def _run(memory, _params, _max_steps, _trace):")
    emit("    _regs = {}")
    emit("    steps = 0")
    emit("    _blocks = _trace.blocks")
    emit("    _loads = _trace.loads")
    emit("    _stores = _trace.stores")
    for a in arrays:
        s = sym(a)
        emit(f"    _mem_{s} = memory[{a!r}].tolist()")
        emit(f"    _cast_{s} = memory[{a!r}].dtype.type")
    for name in sorted(all_names):
        emit(f"    {sym(name)} = _params.get({name!r})")
    emit("    try:")
    emit(f"        _blk = {blk_id[fn.entry]}")
    emit("        _prev = -1")
    emit("        while True:")

    first = True
    for bname, blk in fn.blocks.items():
        bid = blk_id[bname]
        kw = "if" if first else "elif"
        first = False
        emit(f"            {kw} _blk == {bid}:")
        ind = "                "
        emit(f"{ind}_blocks.append({bname!r})")

        if blk.phis:
            preds = []
            for p in blk.phis:
                for (pb, _) in p.args:
                    if pb not in preds:
                        preds.append(pb)
            kw2 = "if"
            for pb in preds:
                dests, srcs = [], []
                for p in blk.phis:
                    for (ppb, v) in p.args:
                        if ppb == pb:
                            dests.append(sym(p.dest))
                            srcs.append(sym(v))
                            break
                    else:
                        dests.append(sym(p.dest))
                        srcs.append(f"_phi_err({p.dest!r}, {bname!r}, "
                                    f"_BNAMES[_prev] if _prev >= 0 else None)")
                emit(f"{ind}{kw2} _prev == {blk_id.get(pb, -2)}:")
                emit(f"{ind}    {', '.join(dests)} = {', '.join(srcs)}")
                kw2 = "elif"
            emit(f"{ind}else:")
            emit(f"{ind}    _phi_err({blk.phis[0].dest!r}, {bname!r}, "
                 f"_BNAMES[_prev] if _prev >= 0 else None)")

        if blk.body:
            emit(f"{ind}steps += {len(blk.body)}")
            emit(f"{ind}if steps > _max_steps:")
            emit(f"{ind}    raise _InterpError("
                 f"'interpreter step budget exceeded')")
        for instr in blk.body:
            op = instr.op
            if op == "const":
                emit(f"{ind}{sym(instr.dest)} = {instr.args[0]!r}")
            elif op == "bin":
                o, a, b = instr.args
                expr = _BINOP_EXPR[o].format(a=val(a), b=val(b))
                emit(f"{ind}{sym(instr.dest)} = {expr}")
            elif op == "select":
                c, a, b = instr.args
                emit(f"{ind}{sym(instr.dest)} = "
                     f"{val(a)} if {val(c)} else {val(b)}")
            elif op == "load":
                s = sym(instr.array)
                emit(f"{ind}_a = int({val(instr.args[0])})")
                emit(f"{ind}_v = _mem_{s}[_a]")
                emit(f"{ind}{sym(instr.dest)} = _v")
                emit(f"{ind}_loads.append(({instr.array!r}, _a, _v))")
            elif op == "store":
                s = sym(instr.array)
                emit(f"{ind}_a = int({val(instr.args[0])})")
                emit(f"{ind}_v = {val(instr.args[1])}")
                emit(f"{ind}_mem_{s}[_a] = _cast_{s}(_v).item()")
                emit(f"{ind}_stores.append(({instr.array!r}, _a, _v))")
            elif op == "setreg":
                if "imm" in instr.meta:
                    emit(f"{ind}_regs[{instr.args[0]!r}] = "
                         f"{instr.meta['imm']!r}")
                else:
                    emit(f"{ind}_regs[{instr.args[0]!r}] = "
                         f"{val(instr.args[1])}")
            elif op == "getreg":
                emit(f"{ind}{sym(instr.dest)} = "
                     f"_regs.get({instr.args[0]!r}, 0)")
            elif op == "print":
                emit(f"{ind}pass")
        emit(f"{ind}_trace.instr_count = steps")

        term = blk.term
        if term.kind == "ret":
            emit(f"{ind}return _trace")
        else:
            if not blk.synthetic:
                emit(f"{ind}_prev = {bid}")
            if term.kind == "br":
                emit(f"{ind}_blk = {blk_id[term.targets[0]]}")
            else:
                emit(f"{ind}_blk = {blk_id[term.targets[0]]} "
                     f"if {sym(term.cond)} else {blk_id[term.targets[1]]}")

    emit("            else:")
    emit("                raise RuntimeError(f'interp: bad block id {_blk}')")
    emit("    finally:")
    for a in arrays:
        s = sym(a)
        emit(f"        memory[{a!r}][:] = _mem_{s}")
    if not arrays:
        emit("        pass")

    src = "\n".join(lines)
    from ..interp import InterpError

    def _phi_err(dest, bname, prev):
        raise InterpError(
            f"phi {dest} in {bname} has no incoming for pred {prev}")

    ns = _compile_ns(src, f"<interp:{fn.name}>",
                     {"_InterpError": InterpError, "_phi_err": _phi_err,
                      "_BNAMES": tuple(bnames)})
    make = ns["_run"]
    make.__source__ = src
    return make
