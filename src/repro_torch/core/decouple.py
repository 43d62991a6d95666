"""The DAE decoupling transform (paper §3.2).

Splits one function into an **AGU** slice (address generation: memory ops on
decoupled arrays become ``send_ld``/``send_st`` requests) and a **CU** slice
(compute: they become ``consume_ld``/``produce_st``), then dead-code
eliminates each slice and control-flow-simplifies the AGU.

A ``send_ld`` whose value is still used by live AGU code keeps
``meta['sync']=True`` — the AGU blocks on the DU round-trip for it (this is
exactly the Fig. 1b loss-of-decoupling).  After speculative hoisting makes
the guarding branch dead, re-running :func:`finalize_agu` flips it to
fire-and-forget (Fig. 1c).
"""
from __future__ import annotations

from typing import Dict, Set, Tuple

from .ir import Function, Instr
from .lod import tag_mids


def decouple(fn: Function, decoupled: Set[str]) -> Tuple[Function, Function]:
    """Return finalized (agu, cu) slices.  ``fn`` is not modified."""
    tag_mids(fn)
    agu = fn.clone()
    agu.name = fn.name + ".agu"
    cu = fn.clone()
    cu.name = fn.name + ".cu"
    decouple_slices(agu, cu, decoupled)
    dce(cu)
    finalize_agu(agu)
    return agu, cu


def decouple_slices(agu: Function, cu: Function,
                    decoupled: Set[str]) -> Tuple[Function, Function]:
    """Rewrite memory ops into DAE communication ops, in place, WITHOUT the
    DCE/simplify finalization (the SPEC pipeline hoists first: §5.1)."""
    for blk in agu.blocks.values():
        new_body = []
        for i in blk.body:
            if i.array in decoupled and i.op == "load":
                new_body.append(Instr("send_ld", i.dest, (i.args[0],), i.array,
                                      dict(i.meta, sync=True)))
            elif i.array in decoupled and i.op == "store":
                # address only — the store *value* belongs to the CU
                new_body.append(Instr("send_st", None, (i.args[0],), i.array,
                                      dict(i.meta)))
            else:
                new_body.append(i)
        blk.body = new_body

    for blk in cu.blocks.values():
        new_body = []
        for i in blk.body:
            if i.array in decoupled and i.op == "load":
                new_body.append(Instr("consume_ld", i.dest, (), i.array,
                                      dict(i.meta)))
            elif i.array in decoupled and i.op == "store":
                new_body.append(Instr("produce_st", None, (i.args[1],), i.array,
                                      dict(i.meta)))
            else:
                new_body.append(i)
        blk.body = new_body
    return agu, cu


# ---------------------------------------------------------------------------
# Dead code elimination
# ---------------------------------------------------------------------------


def dce(fn: Function) -> None:
    """Classic mark&sweep: effectful ops and live terminator conds are roots."""
    defs: Dict[str, Instr] = {}
    for blk in fn.blocks.values():
        for i in blk.instructions():
            if i.dest is not None:
                defs.setdefault(i.dest, i)

    live: Set[str] = set()
    work = []
    for blk in fn.blocks.values():
        for i in blk.instructions():
            if i.is_effect():
                work.extend(i.uses())
        if blk.term.cond is not None:
            work.append(blk.term.cond)
    while work:
        v = work.pop()
        if v in live:
            continue
        live.add(v)
        d = defs.get(v)
        if d is not None:
            work.extend(d.uses())
            if d.op == "phi":
                # keep incoming-block terminators implicitly (all terms kept)
                pass

    for blk in fn.blocks.values():
        blk.phis = [p for p in blk.phis if p.dest in live]
        blk.body = [i for i in blk.body
                    if i.is_effect() or (i.dest is not None and i.dest in live)]


# ---------------------------------------------------------------------------
# AGU control-flow simplification + sync-flag finalization
# ---------------------------------------------------------------------------


def simplify_cfg(fn: Function) -> None:
    """Remove trivial control flow: cbr with equal targets, empty forwarding
    blocks, unreachable blocks.  (The paper's post-DCE cleanup pass.)"""
    changed = True
    while changed:
        changed = False

        # cbr with identical targets -> br
        for blk in fn.blocks.values():
            t = blk.term
            if t.kind == "cbr" and t.targets[0] == t.targets[1]:
                blk.term.kind = "br"
                blk.term.cond = None
                blk.term.targets = (t.targets[0],)
                changed = True

        # empty block with unconditional successor: forward its preds
        preds = fn.preds_map()
        for name in list(fn.blocks):
            blk = fn.blocks[name]
            if name == fn.entry or blk.phis or blk.body:
                continue
            if blk.term.kind != "br":
                continue
            succ = blk.term.targets[0]
            if succ == name:
                continue
            sb = fn.blocks[succ]
            if sb.phis:
                # only safe if no pred of `name` is already a pred of succ
                if any(p in preds.get(succ, ()) for p in preds.get(name, ())):
                    continue
                for p in preds.get(name, ()):
                    # phi entries pointing at `name` must fan out per pred —
                    # duplicate the incoming entry for each forwarded pred
                    for phi in sb.phis:
                        entry = next(((b, v) for (b, v) in phi.args if b == name),
                                     None)
                        if entry is not None:
                            phi.args = tuple((b, v) for (b, v) in phi.args
                                             if b != name) + ((p, entry[1]),)
                for p in preds.get(name, ()):
                    fn.blocks[p].term.retarget(name, succ)
            else:
                for p in preds.get(name, ()):
                    fn.blocks[p].term.retarget(name, succ)
            if name != succ:
                del fn.blocks[name]
                changed = True
                break  # preds map is stale; restart scan

        # unreachable blocks
        reach: Set[str] = set()
        stack = [fn.entry]
        while stack:
            n = stack.pop()
            if n in reach:
                continue
            reach.add(n)
            stack.extend(fn.blocks[n].term.succs())
        for name in list(fn.blocks):
            if name not in reach:
                del fn.blocks[name]
                changed = True
        if changed:
            # drop phi entries from removed/retargeted preds
            preds = fn.preds_map()
            for name, blk in fn.blocks.items():
                for phi in blk.phis:
                    phi.args = tuple((b, v) for (b, v) in phi.args
                                     if b in preds.get(name, ()))


def finalize_agu(fn: Function) -> None:
    """DCE + CFG-simplify the AGU to fixpoint, then mark each ``send_ld`` as
    sync (its value is still consumed by AGU code) or fire-and-forget."""
    for _ in range(10):
        before = _shape(fn)
        # §3.2: "in the AGU, we delete all side effect instructions that are
        # not part of the address generation def-use chains" — a private
        # store to an array the AGU never reads serves no address chain.
        loaded = {i.array for b in fn.blocks.values() for i in b.body
                  if i.op == "load"}
        for blk in fn.blocks.values():
            blk.body = [i for i in blk.body
                        if not (i.op == "store" and i.array not in loaded)]
        dce(fn)
        simplify_cfg(fn)
        dce(fn)
        if _shape(fn) == before:
            break

    used: Set[str] = set()
    for blk in fn.blocks.values():
        for i in blk.instructions():
            used.update(i.uses())
        if blk.term.cond is not None:
            used.add(blk.term.cond)
    for blk in fn.blocks.values():
        for i in blk.body:
            if i.op == "send_ld":
                i.meta["sync"] = i.dest in used


def _shape(fn: Function) -> Tuple:
    return (tuple(fn.blocks),
            tuple(len(b.phis) + len(b.body) for b in fn.blocks.values()))
