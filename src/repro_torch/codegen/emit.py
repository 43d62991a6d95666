"""Slice-to-source emitters: lower IR slices to executable Python/NumPy.

Three emission modes share one skeleton (SSA values become Python locals,
blocks become an ``if/elif`` dispatch over integer labels, phis become
parallel assignments selected on the dynamic predecessor — the same
lowering scheme as :mod:`repro.core.sim.compile`, minus all cycle
accounting, because generated kernels are *untimed executables*, not
simulations):

``agu-stream``
    The software prefetcher.  Runs the AGU slice ahead of time against
    read-only initial memory; ``send_ld``/``send_st`` append straight to
    the per-array :class:`~repro.codegen.streams.Streams` views (raw and
    clamped load addresses, store addresses, stream positions).  A
    surviving *sync* ``send_ld`` reads initial memory directly — :mod:`repro.codegen.analysis` only
    admits this mode when every sync'd array is store-free, so nothing
    older can alias.  AGU-private (non-decoupled) arrays execute on local
    copies that are discarded, exactly like the machine's AGU-local state.

``cu-numpy``
    The coroutine-free CU state machine.  ``consume_ld`` becomes "read
    memory at the next precomputed (clamped) load address",
    ``produce_st`` becomes "write the next precomputed store address",
    and ``poison_st`` becomes the masked write — the slot is consumed,
    nothing is written (the DU's no-replay poison retirement).  CU-local
    arrays are the real output arrays (list mirrors, flushed at ``ret``).

``cu-jax``
    The same CU state machine as a *generator*: ``consume_ld`` pops a
    host-side buffer and yields the array name when it runs dry, and
    ``produce_st``/``poison_st`` append the value (or the POISON
    sentinel) to a per-array out-list.  The jax driver
    (:mod:`repro.codegen.jax_backend`) refills buffers with
    ``spec_gather`` epochs and drains out-lists through
    ``spec_scatter_add`` flushes.

All modes write results back **only on successful completion** (no
``finally`` flush): a run that raises leaves the caller's memory pristine,
so :func:`repro.codegen.run` can re-execute through the coupled fallback
without snapshotting.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.ir import Function
from ..core.sim.compile import _BINOP_EXPR, _compile_ns, _Namer
from .analysis import CodegenError, SLICE_OPS, uniform_loops

MODES = ("agu-stream", "cu-numpy", "cu-jax", "cu-vector")

_DAE_OPS = frozenset({"send_ld", "send_st", "consume_ld", "produce_st",
                      "poison_st"})

# binop -> batched expression over the vector helpers (repro.codegen.vector):
# everything the scalar table wraps in int()/bool() gets a helper that
# applies the same wrapping lane-wise, and the wrap-prone integer ops
# (+,-,*) get overflow-checked helpers.  Integer lanes are int64 — the
# state-machine emitters compute in unbounded Python ints, so a lane
# overflow raises CodegenError and the run retries on the state machine
# rather than committing wrapped values.
_VECOP_EXPR = {
    "+": "_vadd({a}, {b})",
    "-": "_vsub({a}, {b})",
    "*": "_vmul({a}, {b})",
    "//": "_vdiv({a}, {b})",
    "%": "_vmod({a}, {b})",
    "<": "_vlt({a}, {b})",
    "<=": "_vle({a}, {b})",
    ">": "_vgt({a}, {b})",
    ">=": "_vge({a}, {b})",
    "==": "_veq({a}, {b})",
    "!=": "_vne({a}, {b})",
    "&": "_vand({a}, {b})",
    "|": "_vor({a}, {b})",
    "min": "_vmin({a}, {b})",
    "max": "_vmax({a}, {b})",
    "^": "_vxor({a}, {b})",
}


def _supported(fn: Function, mode: str) -> bool:
    # AGU emission lowers send ops; CU emission lowers consume/produce/
    # poison.  The opposite kind appearing means the caller handed the
    # wrong slice — refuse rather than emit dangling references.
    bad = (("consume_ld", "produce_st", "poison_st")
           if mode == "agu-stream" else ("send_ld", "send_st"))
    for blk in fn.blocks.values():
        for i in blk.body:
            if i.op not in SLICE_OPS or i.op in bad:
                return False
            if i.op == "bin" and i.args[0] not in _BINOP_EXPR:
                return False
    return True


def emit_source(fn: Function, mode: str) -> Optional[str]:
    """Emit the Python source for ``fn`` in ``mode``; None if unsupported.

    The text is deterministic for a given Function (stable name mangling,
    stable block numbering) — the golden-emission tests in
    ``tests/test_codegen.py`` pin it.
    """
    if mode not in MODES:
        raise ValueError(f"unknown emission mode {mode!r}")
    if mode == "cu-vector":
        return _emit_vector(fn)
    if not _supported(fn, mode):
        return None

    sym = _Namer()
    blk_id = {name: i for i, name in enumerate(fn.blocks)}
    lines: List[str] = []
    emit = lines.append

    def val(a) -> str:
        """Emit an operand: register symbol or immediate literal."""
        return sym(a) if isinstance(a, str) else repr(a)

    # -- inventory -----------------------------------------------------------
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
    local_arrays = sorted({i.array for b in fn.blocks.values()
                           for i in b.body if i.op in ("load", "store")})
    dec_arrays = sorted({i.array for b in fn.blocks.values()
                         for i in b.body if i.op in _DAE_OPS})
    sync_arrays = sorted({i.array for b in fn.blocks.values()
                          for i in b.body
                          if i.op == "send_ld" and i.meta.get("sync")})

    # -- prologue ------------------------------------------------------------
    if mode == "agu-stream":
        emit("def _run(memory, _params, _max_steps):")
    elif mode == "cu-numpy":
        emit("def _run(memory, _params, _ld, _st, _max_steps):")
    else:  # cu-jax
        emit("def _run(memory, _params, _bufs, _outs, _stats, _max_steps):")
    emit("    _regs = {}")
    emit("    steps = 0")
    for a in local_arrays:
        s = sym(a)
        emit(f"    _loc_{s} = memory[{a!r}].tolist()")
        emit(f"    _cast_{s} = memory[{a!r}].dtype.type")
        emit(f"    _hi_{s} = len(_loc_{s}) - 1")
    if mode == "agu-stream":
        for a in dec_arrays:
            s = sym(a)
            emit(f"    _ldr_{s} = []")
            emit(f"    _ldc_{s} = []")
            emit(f"    _ldp_{s} = []")
            emit(f"    _sta_{s} = []")
            emit(f"    _stp_{s} = []")
            emit(f"    _n_{s} = 0")
            emit(f"    _dhi_{s} = len(memory[{a!r}]) - 1")
        emit("    _syncs = 0")
        for a in sync_arrays:
            s = sym(a)
            emit(f"    _base_{s} = memory[{a!r}].tolist()")
    elif mode == "cu-numpy":
        for a in dec_arrays:
            s = sym(a)
            emit(f"    _mem_{s} = memory[{a!r}].tolist()")
            emit(f"    _cast_{s} = memory[{a!r}].dtype.type")
            emit(f"    _hi_{s} = len(_mem_{s}) - 1")
            emit(f"    _ldq_{s} = _ld[{a!r}]")
            emit(f"    _ldn_{s} = len(_ldq_{s})")
            emit(f"    _lp_{s} = 0")
            emit(f"    _stq_{s} = _st[{a!r}]")
            emit(f"    _stn_{s} = len(_stq_{s})")
            emit(f"    _sp_{s} = 0")
        emit("    _committed = 0")
        emit("    _poisoned = 0")
    else:  # cu-jax
        emit("    yield from ()  # generator even with no consume_ld")
        for a in dec_arrays:
            s = sym(a)
            emit(f"    _buf_{s} = _bufs[{a!r}]")
            emit(f"    _out_{s} = _outs[{a!r}]")
        emit("    _committed = 0")
        emit("    _poisoned = 0")
        emit("    _consumed = 0")
    for name in sorted(all_names):
        emit(f"    {sym(name)} = _params.get({name!r})")
    emit(f"    _blk = {blk_id[fn.entry]}")
    emit("    _prev = -1")
    emit("    while True:")

    # -- blocks --------------------------------------------------------------
    first = True
    for bname, blk in fn.blocks.items():
        bid = blk_id[bname]
        kw = "if" if first else "elif"
        first = False
        emit(f"        {kw} _blk == {bid}:")
        ind = "            "
        emitted_any = False

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
                        srcs.append(f"_phi_err({p.dest!r}, {bname!r}, _prev)")
                emit(f"{ind}{kw2} _prev == {blk_id.get(pb, -2)}:")
                emit(f"{ind}    {', '.join(dests)} = {', '.join(srcs)}")
                kw2 = "elif"
            emit(f"{ind}else:")
            emit(f"{ind}    _phi_err({blk.phis[0].dest!r}, {bname!r}, _prev)")
            emitted_any = True

        if blk.body:
            emit(f"{ind}steps += {len(blk.body)}")
            emit(f"{ind}if steps > _max_steps:")
            emit(f"{ind}    raise _CodegenError("
                 f"'generated kernel step budget exceeded')")
            emitted_any = True
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
                emit(f"{ind}if _a < 0: _a = 0")
                emit(f"{ind}elif _a > _hi_{s}: _a = _hi_{s}")
                emit(f"{ind}{sym(instr.dest)} = _loc_{s}[_a]")
            elif op == "store":
                s = sym(instr.array)
                emit(f"{ind}_a = int({val(instr.args[0])})")
                emit(f"{ind}if 0 <= _a <= _hi_{s}:")
                emit(f"{ind}    _loc_{s}[_a] = "
                     f"_cast_{s}({val(instr.args[1])}).item()")
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
            elif op == "send_ld":
                s = sym(instr.array)
                emit(f"{ind}_a = int({val(instr.args[0])})")
                emit(f"{ind}_ldr_{s}.append(_a)")
                emit(f"{ind}_c = 0 if _a < 0 else "
                     f"(_dhi_{s} if _a > _dhi_{s} else _a)")
                emit(f"{ind}_ldc_{s}.append(_c)")
                emit(f"{ind}_ldp_{s}.append(_n_{s})")
                emit(f"{ind}_n_{s} += 1")
                if instr.meta.get("sync"):
                    # analysis guarantees the array is store-free: the DU
                    # would serve this from initial memory, so we do too
                    emit(f"{ind}{sym(instr.dest)} = _base_{s}[_c]")
                    emit(f"{ind}_syncs += 1")
            elif op == "send_st":
                s = sym(instr.array)
                emit(f"{ind}_sta_{s}.append(int({val(instr.args[0])}))")
                emit(f"{ind}_stp_{s}.append(_n_{s})")
                emit(f"{ind}_n_{s} += 1")
            elif op == "consume_ld":
                s = sym(instr.array)
                if mode == "cu-numpy":
                    emit(f"{ind}if _lp_{s} >= _ldn_{s}:")
                    emit(f"{ind}    raise _CodegenError("
                         f"'load stream underrun @{instr.array}')")
                    emit(f"{ind}{sym(instr.dest)} = "
                         f"_mem_{s}[_ldq_{s}[_lp_{s}]]")
                    emit(f"{ind}_lp_{s} += 1")
                else:  # cu-jax
                    emit(f"{ind}while not _buf_{s}:")
                    emit(f"{ind}    yield {instr.array!r}")
                    emit(f"{ind}{sym(instr.dest)} = _buf_{s}.popleft()")
                    emit(f"{ind}_consumed += 1")
            elif op in ("produce_st", "poison_st"):
                s = sym(instr.array)
                ind2 = ind
                if op == "poison_st":
                    pr = instr.meta.get("pred_reg")
                    if pr is not None:
                        emit(f"{ind}if _regs.get({pr!r}, 0):")
                        ind2 = ind + "    "
                if mode == "cu-numpy":
                    emit(f"{ind2}if _sp_{s} >= _stn_{s}:")
                    emit(f"{ind2}    raise _CodegenError("
                         f"'store stream underrun @{instr.array}')")
                    if op == "produce_st":
                        emit(f"{ind2}_a = _stq_{s}[_sp_{s}]")
                        emit(f"{ind2}if _a < 0 or _a > _hi_{s}:")
                        emit(f"{ind2}    raise _CodegenError("
                             f"'non-poisoned store out of bounds "
                             f"@{instr.array}')")
                        emit(f"{ind2}_mem_{s}[_a] = "
                             f"_cast_{s}({val(instr.args[0])}).item()")
                        emit(f"{ind2}_committed += 1")
                    else:
                        emit(f"{ind2}_poisoned += 1")
                    emit(f"{ind2}_sp_{s} += 1")
                else:  # cu-jax
                    if op == "produce_st":
                        emit(f"{ind2}_out_{s}.append("
                             f"{val(instr.args[0])})")
                        emit(f"{ind2}_committed += 1")
                    else:
                        emit(f"{ind2}_out_{s}.append(_POISON)")
                        emit(f"{ind2}_poisoned += 1")
            elif op == "print":
                emit(f"{ind}pass")

        term = blk.term
        if term.kind == "ret":
            # success epilogue: flush mirrors, hand back results.  No
            # finally-flush — a raising run must leave memory pristine.
            if mode == "agu-stream":
                def dmap(stem: str) -> str:
                    """Emit a per-array dict literal over the decoupled set."""
                    return ("{" + ", ".join(f"{a!r}: {stem}_{sym(a)}"
                                            for a in dec_arrays) + "}")
                emit(f"{ind}return _Streams(ld_raw={dmap('_ldr')}, "
                     f"ld_clamped={dmap('_ldc')}, st_addrs={dmap('_sta')}, "
                     f"ld_pos={dmap('_ldp')}, st_pos={dmap('_stp')}, "
                     f"sync_reads=_syncs)")
            elif mode == "cu-numpy":
                for a in local_arrays:
                    emit(f"{ind}memory[{a!r}][:] = _loc_{sym(a)}")
                for a in dec_arrays:
                    emit(f"{ind}memory[{a!r}][:] = _mem_{sym(a)}")
                lds = " + ".join(f"_lp_{sym(a)}" for a in dec_arrays) or "0"
                ldo = " + ".join(f"_ldn_{sym(a)} - _lp_{sym(a)}"
                                 for a in dec_arrays) or "0"
                sto = " + ".join(f"_stn_{sym(a)} - _sp_{sym(a)}"
                                 for a in dec_arrays) or "0"
                emit(f"{ind}return {{'stores_committed': _committed, "
                     f"'stores_poisoned': _poisoned, "
                     f"'loads_consumed': {lds}, "
                     f"'ld_leftover': {ldo}, 'st_leftover': {sto}}}")
            else:  # cu-jax
                # local mirrors are handed to the driver, NOT written back
                # here: the driver's drain flush can still fail (jax
                # subset violation) and must leave memory pristine for
                # the fallback — it applies these only after every
                # device-side flush succeeded
                emit(f"{ind}_stats['locals'] = {{"
                     + ", ".join(f"{a!r}: _loc_{sym(a)}"
                                 for a in local_arrays) + "}")
                emit(f"{ind}_stats['stores_committed'] = _committed")
                emit(f"{ind}_stats['stores_poisoned'] = _poisoned")
                emit(f"{ind}_stats['loads_consumed'] = _consumed")
                emit(f"{ind}return")
        else:
            if not blk.synthetic:
                emit(f"{ind}_prev = {bid}")
            if term.kind == "br":
                emit(f"{ind}_blk = {blk_id[term.targets[0]]}")
            else:
                emit(f"{ind}_blk = {blk_id[term.targets[0]]} "
                     f"if {sym(term.cond)} else {blk_id[term.targets[1]]}")
            emitted_any = True
        if not emitted_any:
            emit(f"{ind}pass")

    emit("        else:")
    emit("            raise RuntimeError(f'codegen: bad block id {_blk}')")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# cu-vector: whole epochs as batched numpy expressions
# ---------------------------------------------------------------------------


def _emit_vector(fn: Function) -> Optional[str]:
    """Vectorised CU: iteration-uniform loops run as epoch-batched array ops.

    Loop control and code between loops stay a scalar state machine (same
    dispatch skeleton as ``cu-numpy``), but each iteration-uniform
    innermost loop collapses to an epoch loop: the driver plans a window
    of ``m`` whole iterations (:mod:`repro.codegen.epochs`), serves every
    ``consume_ld`` as a strided view of one bulk gather, the body runs
    if-converted (block predicates are boolean lanes, ``cbr`` becomes
    predicate arithmetic, join values become selects), and every store
    slot ends up as one (value, poison-mask) lane pair handed back in a
    single commit.  The driver may cut the window at the first committed
    RAW hazard (optimistic disambiguation — see ``epochs.first_violation``)
    and returns how many iterations actually retired; local-array stores
    are applied after the cut for exactly that prefix.

    Memory is written back only on success: locals live in private numpy
    copies returned via ``stats['locals']``, decoupled state lives in the
    driver.
    """
    loops, _ = uniform_loops(fn)
    if loops is None:
        return None
    for blk in fn.blocks.values():
        for i in blk.body:
            if i.op not in SLICE_OPS or i.op in ("send_ld", "send_st"):
                return None
            if i.op == "bin" and i.args[0] not in _BINOP_EXPR:
                return None

    sym = _Namer()
    blk_id = {name: i for i, name in enumerate(fn.blocks)}
    region_of: Dict[str, int] = {}
    for lid, ul in enumerate(loops):
        for b in ul.blocks:
            region_of[b] = lid
    headers = {ul.header: lid for lid, ul in enumerate(loops)}

    lines: List[str] = []
    emit = lines.append

    # -- inventory ----------------------------------------------------------
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
    local_arrays = sorted({i.array for b in fn.blocks.values()
                           for i in b.body if i.op in ("load", "store")})

    # -- prologue -----------------------------------------------------------
    emit("def _run(memory, _params, _drv, _max_steps):")
    emit("    _regs = {}")
    emit("    steps = 0")
    for a in local_arrays:
        s = sym(a)
        emit(f"    _loc_{s} = memory[{a!r}].copy()")
        emit(f"    _cast_{s} = memory[{a!r}].dtype.type")
        emit(f"    _hi_{s} = len(_loc_{s}) - 1")
    for name in sorted(all_names):
        emit(f"    {sym(name)} = _params.get({name!r})")
    emit(f"    _blk = {blk_id[fn.entry]}")
    emit("    _prev = -1")
    emit("    while True:")

    first = True
    for bname, blk in fn.blocks.items():
        if bname in region_of:
            continue  # inlined into its loop's epoch section
        bid = blk_id[bname]
        kw = "if" if first else "elif"
        first = False
        emit(f"        {kw} _blk == {bid}:")
        ind = "            "
        if bname in headers:
            _emit_vector_loop(fn, loops[headers[bname]], headers[bname],
                              sym, blk_id, emit, ind)
            continue
        emitted_any = _emit_scalar_block(fn, bname, blk, sym, blk_id, emit,
                                         ind, local_arrays)
        if not emitted_any:
            emit(f"{ind}pass")

    emit("        else:")
    emit("            raise RuntimeError(f'codegen: bad block id {_blk}')")
    return "\n".join(lines)


def _emit_scalar_block(fn, bname, blk, sym, blk_id, emit, ind,
                       local_arrays) -> bool:
    """Non-loop block in cu-vector mode: scalar ops over numpy locals."""

    def val(a) -> str:
        """Emit an operand: register symbol or immediate literal."""
        return sym(a) if isinstance(a, str) else repr(a)

    emitted_any = False
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
                    srcs.append(f"_phi_err({p.dest!r}, {bname!r}, _prev)")
            emit(f"{ind}{kw2} _prev == {blk_id.get(pb, -2)}:")
            emit(f"{ind}    {', '.join(dests)} = {', '.join(srcs)}")
            kw2 = "elif"
        emit(f"{ind}else:")
        emit(f"{ind}    _phi_err({blk.phis[0].dest!r}, {bname!r}, _prev)")
        emitted_any = True

    if blk.body:
        emit(f"{ind}steps += {len(blk.body)}")
        emit(f"{ind}if steps > _max_steps:")
        emit(f"{ind}    raise _CodegenError("
             f"'generated kernel step budget exceeded')")
        emitted_any = True
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
            emit(f"{ind}if _a < 0: _a = 0")
            emit(f"{ind}elif _a > _hi_{s}: _a = _hi_{s}")
            emit(f"{ind}{sym(instr.dest)} = _loc_{s}[_a].item()")
        elif op == "store":
            s = sym(instr.array)
            emit(f"{ind}_a = int({val(instr.args[0])})")
            emit(f"{ind}if 0 <= _a <= _hi_{s}:")
            emit(f"{ind}    _loc_{s}[_a] = "
                 f"_cast_{s}({val(instr.args[1])})")
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

    term = blk.term
    if term.kind == "ret":
        emit(f"{ind}_stats = _drv.stats()")
        emit(f"{ind}_stats['locals'] = {{"
             + ", ".join(f"{a!r}: _loc_{sym(a)}" for a in local_arrays)
             + "}")
        emit(f"{ind}return _stats")
        emitted_any = True
    else:
        if not blk.synthetic:
            emit(f"{ind}_prev = {blk_id[bname]}")
        if term.kind == "br":
            emit(f"{ind}_blk = {blk_id[term.targets[0]]}")
        else:
            emit(f"{ind}_blk = {blk_id[term.targets[0]]} "
                 f"if {sym(term.cond)} else {blk_id[term.targets[1]]}")
        emitted_any = True
    return emitted_any


def _emit_vector_loop(fn, ul, lid, sym, blk_id, emit, ind) -> None:
    """Epoch section for one iteration-uniform loop, at its header's id.

    The if-converted region is wrapped in a ``_body(_ld)`` closure so the
    driver can re-evaluate the whole epoch under *forwarded* load
    estimates (the segmented-scan RAW fixpoint — see
    :mod:`repro.codegen.epochs`): ``_body`` takes the per-array load
    lanes, returns the store slot lanes plus the deferred local-array
    stores, and must stay pure with respect to pre-epoch state (local
    arrays are only read; their stores are applied after the commit cut,
    for exactly the retired prefix).
    """

    def val(a) -> str:
        """Emit an operand: register symbol or immediate literal."""
        return sym(a) if isinstance(a, str) else repr(a)

    hb = fn.blocks[ul.header]
    phi = hb.phis[0]
    non_latch = [(pb, v) for (pb, v) in phi.args if pb != ul.latch]
    kw = "if"
    for (pb, v) in non_latch:
        emit(f"{ind}{kw} _prev == {blk_id.get(pb, -2)}:")
        emit(f"{ind}    _iv0 = {sym(v)}")
        kw = "elif"
    emit(f"{ind}else:")
    emit(f"{ind}    _phi_err({phi.dest!r}, {ul.header!r}, _prev)")
    emit(f"{ind}_T = {val(ul.bound)} - _iv0")
    emit(f"{ind}if _T < 0: _T = 0")
    emit(f"{ind}_t0 = 0")
    emit(f"{ind}while _t0 < _T:")
    ind2 = ind + "    "
    emit(f"{ind2}_m = _drv.plan({lid}, _T - _t0)")
    emit(f"{ind2}_ld0 = _drv.gather({lid}, _m)")
    emit(f"{ind2}def _body(_ld):")
    bind = ind2 + "    "
    emit(f"{bind}{sym(ul.iv)} = _iv0 + _t0 + _np.arange(_m)")

    # per-slot accumulators: value lanes and poison-mask lanes
    slot_arrays = sorted(a for a, s in ul.k_stores.items() if s)
    for a in slot_arrays:
        for s in range(ul.k_stores[a]):
            emit(f"{bind}_sv_{sym(a)}_{s} = 0")
            emit(f"{bind}_sp_{sym(a)}_{s} = False")

    # if-converted region: block predicates, straight-line lanes
    pred_of: Dict[str, str] = {}
    in_edges: Dict[str, List[str]] = {b: [] for b in ul.blocks}
    loff: Dict[str, Dict[str, int]] = {ul.blocks[0]: {}}
    soff: Dict[str, Dict[str, int]] = {ul.blocks[0]: {}}
    local_stores: List[Tuple[str, str, str, str]] = []
    for bi, bname in enumerate(ul.blocks):
        blk = fn.blocks[bname]
        pv = f"_p{bi}"
        if bi == 0:
            emit(f"{bind}{pv} = True")
        else:
            terms = in_edges[bname]
            emit(f"{bind}{pv} = {terms[0]}")
            for t in terms[1:]:
                emit(f"{bind}{pv} = {pv} | {t}")
        pred_of[bname] = pv

        lo = dict(loff[bname])
        so = dict(soff[bname])
        for instr in blk.body:
            op = instr.op
            if op == "const":
                emit(f"{bind}{sym(instr.dest)} = {instr.args[0]!r}")
            elif op == "bin":
                o, a, b = instr.args
                expr = _VECOP_EXPR[o].format(a=val(a), b=val(b))
                emit(f"{bind}{sym(instr.dest)} = {expr}")
            elif op == "select":
                c, a, b = instr.args
                emit(f"{bind}{sym(instr.dest)} = "
                     f"_vsel({val(c)}, {val(a)}, {val(b)})")
            elif op == "load":
                s = sym(instr.array)
                emit(f"{bind}{sym(instr.dest)} = "
                     f"_vload(_loc_{s}, {val(instr.args[0])}, _hi_{s})")
            elif op == "store":
                s = sym(instr.array)
                local_stores.append(
                    (s, val(instr.args[0]), val(instr.args[1]), pv))
            elif op == "consume_ld":
                k = lo.get(instr.array, 0)
                lo[instr.array] = k + 1
                kk = ul.k_loads[instr.array]
                emit(f"{bind}{sym(instr.dest)} = "
                     f"_ld[{instr.array!r}][{k}::{kk}]")
            elif op == "produce_st":
                s = so.get(instr.array, 0)
                so[instr.array] = s + 1
                t = f"_sv_{sym(instr.array)}_{s}"
                emit(f"{bind}{t} = _vwhere({pv}, "
                     f"{val(instr.args[0])}, {t})")
            elif op == "poison_st":
                s = so.get(instr.array, 0)
                so[instr.array] = s + 1
                t = f"_sp_{sym(instr.array)}_{s}"
                emit(f"{bind}{t} = {t} | {pv}")
            elif op == "print":
                emit(f"{bind}pass")

        term = blk.term
        if term.kind == "cbr":
            t0, t1 = term.targets
            if t0 in in_edges:
                in_edges[t0].append(f"_band({pv}, {val(term.cond)})")
                loff.setdefault(t0, lo)
                soff.setdefault(t0, so)
            if t1 in in_edges:
                in_edges[t1].append(f"_bnot({pv}, {val(term.cond)})")
                loff.setdefault(t1, lo)
                soff.setdefault(t1, so)
        else:
            t0 = term.targets[0]
            if t0 in in_edges:
                in_edges[t0].append(pv)
                loff.setdefault(t0, lo)
                soff.setdefault(t0, so)

    stores = "{" + ", ".join(
        f"{a!r}: (({', '.join(f'_sv_{sym(a)}_{s}' for s in range(ul.k_stores[a]))},), "
        f"({', '.join(f'_sp_{sym(a)}_{s}' for s in range(ul.k_stores[a]))},))"
        for a in slot_arrays) + "}"
    locs = "[" + ", ".join(
        f"(_loc_{s}, _hi_{s}, {ix}, {v}, {pv})"
        for (s, ix, v, pv) in local_stores) + "]"
    emit(f"{bind}return {stores}, {locs}")
    emit(f"{ind2}_m2, _locs = _drv.commit({lid}, _m, _body, _ld0)")
    emit(f"{ind2}for _la, _lh, _lx, _lv, _lp in _locs:")
    emit(f"{ind2}    _vstore(_la, _lx, _lv, _lp, _lh, _m2)")
    emit(f"{ind2}_t0 += _m2")
    emit(f"{ind2}steps += _m2 * {ul.n_ops}")
    emit(f"{ind2}if steps > _max_steps:")
    emit(f"{ind2}    raise _CodegenError("
         f"'generated kernel step budget exceeded')")
    emit(f"{ind}{sym(ul.iv)} = _iv0 + _T")
    emit(f"{ind}_prev = {blk_id[ul.header]}")
    emit(f"{ind}_blk = {blk_id[ul.exit]}")


# ---------------------------------------------------------------------------
# exec-compilation, memoised per Function (same contract as sim.compile:
# a Function must not be mutated after it first runs)
# ---------------------------------------------------------------------------

_ATTR = {"agu-stream": "_codegen_agu_make",
         "cu-numpy": "_codegen_cu_numpy_make",
         "cu-jax": "_codegen_cu_jax_make",
         "cu-vector": "_codegen_cu_vector_make"}


def _phi_err(dest, bname, prev):
    raise CodegenError(f"phi {dest} in {bname}: no incoming for pred {prev}")


def _build_runner(fn: Function, mode: str, src: str):
    """exec ``src`` (an ``emit_source`` text) into a runner for ``mode``."""
    from ..core.sim.base import POISON
    from .streams import Streams
    base = {"_CodegenError": CodegenError, "_phi_err": _phi_err,
            "_POISON": POISON, "_Streams": Streams}
    if mode == "cu-vector":
        from .vector import VECTOR_NS
        base.update(VECTOR_NS)
    ns = _compile_ns(src, f"<codegen-{mode}:{fn.name}>", base)
    make = ns["_run"]
    make.__source__ = src
    return make


def preload_source(fn: Function, mode: str, src: Optional[str]) -> None:
    """Memoise a previously-emitted source as ``fn``'s runner for ``mode``.

    The frontend compile cache stores ``emit_source`` texts; on a warm
    hit it preloads them here so :func:`compile_mode` never re-walks the
    IR.  ``src=None`` records an emission refusal (the mode's cold-path
    outcome) the same way.
    """
    setattr(fn, _ATTR[mode],
            None if src is None else _build_runner(fn, mode, src))


def compile_mode(fn: Function, mode: str):
    """Compile ``fn`` in ``mode``; returns the runner or None (unsupported).

    ``agu-stream`` runners have signature ``(memory, params, max_steps) ->
    Streams``; ``cu-numpy``: ``(memory, params, ld, st, max_steps) ->
    stats``; ``cu-jax``: ``(memory, params, bufs, outs, stats, max_steps)
    -> generator``.
    """
    attr = _ATTR[mode]
    try:
        return getattr(fn, attr)
    except AttributeError:
        pass
    src = emit_source(fn, mode)
    make = None if src is None else _build_runner(fn, mode, src)
    setattr(fn, attr, make)
    return make
