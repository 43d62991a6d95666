"""IR-to-Python source compiler for the sequential interpreter.

Lowers a :class:`~repro_torch.core.ir.Function` to Python source once —
SSA values become Python locals, binops are inlined, blocks become an
``if/elif`` dispatch over integer labels, and phi nodes become parallel
tuple assignments selected by the dynamic predecessor — then
``exec``-compiles it.  :func:`compile_interp` is the fast path of
:func:`repro_torch.core.interp.run`; ``_BINOP_EXPR``, ``_Namer`` and
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
