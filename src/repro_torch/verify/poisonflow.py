"""Poison-flow soundness pass (rules P01/P02/P03, plus D03 ordering).

A *read-only* forward analysis over the CU slice of a
:class:`repro_torch.core.pipeline.CompiledDAE`, deliberately independent of
``repro_torch.codegen`` (see ``docs/verify.md`` for the independence argument).
Three properties are re-derived from the IR:

**P01 — taint guarding.**  Every value produced by a *speculative*
``consume_ld`` (a load the compiler hoisted above a control decision,
``meta['speculative']``) is tracked through a forward taint closure
(bin/select/phi/load/register propagation).  A tainted value reaching an
architectural write (``store`` / ``produce_st``) is only sound when the
write is *controlled by* the speculation it depends on: the write block
must not post-dominate the speculation head — otherwise the write commits
whether or not the speculated path was the taken one, and a
mis-speculated value escapes into memory.

**P03 — steering discipline.**  Every steering register read by the CU
(a ``getreg`` feeding a synthetic steer branch, or a ``pred_reg``-guarded
``poison_st``) must be reset to 0 on a path-dominating block of the
innermost loop containing the read and set to 1 somewhere in that loop.
A missing reset lets last iteration's flag leak into this one (a poison
fires — or fails to fire — for the wrong iteration's request).

**P02 / D03 — request-token matching.**  For every feasible
single-iteration path of every CU loop (enumerated over the loop-body
DAG of :class:`repro_torch.core.cfg.CFGInfo`, with steering registers
concretely simulated to prune infeasible steer paths), the per-array
sequence of CU tokens (``consume_ld``/``produce_st``/``poison_st``) must
equal, element for element, the per-array sequence of AGU requests fired
on the same path.  A count/membership mismatch is P02 (an unanswered
request wedges the DU FIFO); a pure ordering mismatch is D03 (the fence
premise of ``gather_limit`` — per-array FIFO order — is broken even
though every request is eventually answered).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core.cfg import CFGInfo
from ..core.ir import Function, Instr
from .rules import Diag

#: per-loop path-enumeration budget; beyond this the program shape is out
#: of the verifier's proven coverage and we refuse loudly (C03) instead
#: of silently sampling
MAX_PATHS = 20_000

_UNKNOWN = object()


class Coverage(Exception):
    """Raised when a program shape exceeds the verifier's proven coverage.

    Carries the C03 :class:`Diag`; callers convert it into a finding
    rather than letting it escape — the verifier refuses loudly instead
    of sampling or guessing.
    """

    def __init__(self, diag: Diag) -> None:
        """Wrap the C03 diagnostic to surface."""
        super().__init__(str(diag))
        self.diag = diag


def super_nodes_for(cfg: CFGInfo, header: Optional[str]) -> Set[str]:
    """Inner-loop headers collapsed to opaque nodes at this loop level."""
    body = cfg.loops[header] if header is not None else set(cfg.fn.blocks)
    return {h for h in cfg.loops
            if h != header and h in body and
            (header is None or cfg.loops[h] < cfg.loops[header])}


# ---------------------------------------------------------------------------
# P01 — taint guarding
# ---------------------------------------------------------------------------


def taint_check(cu: Function, cfg: CFGInfo) -> List[Diag]:
    """Forward taint from speculative consumes; flag unguarded commits."""
    taint: Dict[str, Set[str]] = {}
    reg_taint: Dict[str, Set[str]] = {}
    sites: List[Tuple[str, Instr]] = [
        (bname, i)
        for bname, blk in cu.blocks.items()
        for i in (*blk.phis, *blk.body)
    ]

    changed = True
    while changed:
        changed = False
        for bname, i in sites:
            t: Set[str] = set()
            if i.op == "consume_ld" and i.meta.get("speculative"):
                t.add(i.meta.get("spec_head", bname))
            if i.op == "getreg":
                t |= reg_taint.get(i.args[0], set())
            for u in i.uses():
                t |= taint.get(u, set())
            if i.op == "setreg":
                cur = reg_taint.setdefault(i.args[0], set())
            elif i.dest is not None:
                cur = taint.setdefault(i.dest, set())
            else:
                continue
            if not t <= cur:
                cur |= t
                changed = True

    diags: List[Diag] = []
    for bname, blk in cu.blocks.items():
        for i in blk.body:
            if i.op not in ("store", "produce_st"):
                continue
            heads: Set[str] = set()
            for u in i.uses():
                heads |= taint.get(u, set())
            for h in sorted(heads):
                if h in cu.blocks and cfg.post_dominates(bname, h):
                    diags.append(Diag(
                        "P01-poison-escapes-commit", f"cu:{bname}",
                        f"{i.op} @{i.array} commits a value tainted by the "
                        f"speculation at {h}, but {bname} post-dominates "
                        f"{h} (the write retires on mis-speculated paths "
                        f"too)"))
    return diags


# ---------------------------------------------------------------------------
# P03 — steering-register discipline
# ---------------------------------------------------------------------------


def steer_check(cu: Function, cfg: CFGInfo) -> List[Diag]:
    """Every steering flag: reset in its loop header, set in its loop."""
    reads: List[Tuple[str, str]] = []  # (reg, block)
    resets: Dict[str, Set[str]] = {}   # reg -> blocks with setreg imm=0
    sets: Dict[str, Set[str]] = {}     # reg -> blocks with setreg imm=1
    for bname, blk in cu.blocks.items():
        for i in blk.body:
            if i.op == "getreg":
                reads.append((i.args[0], bname))
            elif i.op == "poison_st" and i.meta.get("pred_reg"):
                reads.append((i.meta["pred_reg"], bname))
            elif i.op == "setreg" and "imm" in i.meta:
                tgt = sets if i.meta["imm"] else resets
                tgt.setdefault(i.args[0], set()).add(bname)

    diags: List[Diag] = []
    seen: Set[Tuple[str, str]] = set()
    for reg, bname in reads:
        loop = cfg.innermost_loop(bname)
        if loop is not None:
            ok_reset = any(r in cfg.loops[loop] and cfg.dominates(r, bname)
                           for r in resets.get(reg, ()))
            ok_set = any(s in cfg.loops[loop] for s in sets.get(reg, ()))
        else:
            ok_reset = any(cfg.dominates(r, bname)
                           for r in resets.get(reg, ()))
            ok_set = bool(sets.get(reg))
        for ok, what in ((ok_reset, "reset (setreg imm 0) dominating"),
                         (ok_set, "set (setreg imm 1) reaching")):
            if not ok and (reg, what) not in seen:
                seen.add((reg, what))
                where = (f"the {loop} iteration" if loop else "the read")
                diags.append(Diag(
                    "P03-steer-discipline", f"cu:{bname}",
                    f"steering flag {reg!r} is read with no {what} it "
                    f"inside {where} — the flag can carry a stale value "
                    f"across iterations"))
    return diags


# ---------------------------------------------------------------------------
# Feasible-path enumeration with concrete steering-register simulation
# ---------------------------------------------------------------------------


def iter_fired(cu: Function, cfg: CFGInfo, header: Optional[str]
               ) -> Iterator[Tuple[List[str], List[Tuple[str, Instr]]]]:
    """Yield ``(path, fired)`` for each *feasible* iteration path.

    ``path`` is a block-name list over the region DAG of ``header``'s
    loop (function level when ``header`` is None, inner loops collapsed);
    ``fired`` lists the DAE token instructions that actually execute on
    it — a ``pred_reg``-guarded ``poison_st`` is included only when the
    simulated steering flag is set.  Paths whose steer branches
    contradict the simulated flags are dropped.  Raises :class:`Coverage`
    when a needed register value is not statically known or the path
    count exceeds :data:`MAX_PATHS`.
    """
    src = header if header is not None else cu.entry
    supers = super_nodes_for(cfg, header)
    n_paths = 0
    for path in cfg.region_paths(src, header):
        n_paths += 1
        if n_paths > MAX_PATHS:
            raise Coverage(Diag(
                "C03-unsupported-shape", f"cu:{src}",
                f"more than {MAX_PATHS} iteration paths in "
                f"{header or '<function>'} — beyond the verifier's "
                f"enumeration budget"))
        fired = _walk(cu, path, supers)
        if fired is not None:
            yield path, fired


def _walk(cu: Function, path: List[str], supers: Set[str]
          ) -> Optional[List[Tuple[str, Instr]]]:
    """Simulate one path; None = infeasible, else the fired token list."""
    regs: Dict[str, object] = {}
    vals: Dict[str, object] = {}
    fired: List[Tuple[str, Instr]] = []
    for idx, bname in enumerate(path):
        if bname in supers:
            continue  # collapsed inner loop: checked at its own level
        blk = cu.blocks[bname]
        for i in blk.body:
            if i.op == "setreg":
                if "imm" in i.meta:
                    regs[i.args[0]] = i.meta["imm"]
                else:
                    regs[i.args[0]] = vals.get(i.args[1], _UNKNOWN)
            elif i.op == "getreg":
                vals[i.dest] = regs.get(i.args[0], _UNKNOWN)
            elif i.op in ("consume_ld", "produce_st"):
                fired.append((bname, i))
            elif i.op == "poison_st":
                pred = i.meta.get("pred_reg")
                if pred is not None:
                    v = regs.get(pred, _UNKNOWN)
                    if v is _UNKNOWN:
                        raise Coverage(Diag(
                            "C03-unsupported-shape", f"cu:{bname}",
                            f"predicated poison_st @{i.array} reads flag "
                            f"{pred!r} whose value is not statically "
                            f"known on this path"))
                    if not v:
                        continue
                fired.append((bname, i))
        # feasibility: a branch on a *known register* value must agree
        # with the path's next block (prunes contradictory steer paths)
        if idx + 1 < len(path) and blk.term.kind == "cbr":
            v = vals.get(blk.term.cond, _UNKNOWN)
            if v is not _UNKNOWN:
                want = blk.term.targets[0] if v else blk.term.targets[1]
                if path[idx + 1] != want:
                    return None
    return fired


# ---------------------------------------------------------------------------
# P02 / D03 — per-path request-token matching
# ---------------------------------------------------------------------------


def _path_requests(agu: Function, path: List[str],
                   supers: Set[str]) -> Dict[str, List[Tuple[str, int]]]:
    """AGU requests fired on the CU path (same block names, body order)."""
    reqs: Dict[str, List[Tuple[str, int]]] = {}
    for bname in path:
        if bname in supers:
            continue
        blk = agu.blocks.get(bname)
        if blk is None:
            continue  # CU-synthetic (poison/steer) or AGU-dead block
        for i in blk.body:
            if i.op == "send_ld":
                reqs.setdefault(i.array, []).append(
                    ("ld", i.meta.get("mid", -1)))
            elif i.op == "send_st":
                reqs.setdefault(i.array, []).append(
                    ("st", i.meta.get("mid", -1)))
    return reqs


def match_tokens(agu: Function, cu: Function, cfg: CFGInfo) -> List[Diag]:
    """Check per-array request/token agreement on every feasible path."""
    diags: List[Diag] = []
    for header in [*cfg.loops, None]:
        supers = super_nodes_for(cfg, header)
        try:
            for path, fired in iter_fired(cu, cfg, header):
                tokens: Dict[str, List[Tuple[str, int]]] = {}
                for _, i in fired:
                    kind = "ld" if i.op == "consume_ld" else "st"
                    tokens.setdefault(i.array, []).append(
                        (kind, i.meta.get("mid", -1)))
                reqs = _path_requests(agu, path, supers)
                d = _compare(reqs, tokens, header, path)
                if d is not None:
                    diags.append(d)
                    break  # first bad path per loop is enough signal
        except Coverage as e:
            diags.append(e.diag)
    return diags


def _compare(reqs: Dict[str, List[Tuple[str, int]]],
             tokens: Dict[str, List[Tuple[str, int]]],
             header: Optional[str], path: List[str]) -> Optional[Diag]:
    """One feasible path: per-array sequences must be identical."""
    where = f"loop {header}" if header else "function level"
    route = "->".join(path[:6]) + ("..." if len(path) > 6 else "")
    for a in sorted(set(reqs) | set(tokens)):
        r = reqs.get(a, [])
        t = tokens.get(a, [])
        if r == t:
            continue
        if sorted(r) == sorted(t):
            return Diag(
                "D03-epoch-fence-violated", f"cu:{path[-1]}",
                f"array {a!r}: CU token order {t} differs from AGU "
                f"request order {r} on path {route} ({where}) — per-array "
                f"FIFO order (the gather_limit fence premise) is broken")
        return Diag(
            "P02-request-unresolved", f"cu:{path[-1]}",
            f"array {a!r}: AGU fires {len(r)} request(s) {r} but the CU "
            f"resolves {len(t)} token(s) {t} on path {route} ({where}) — "
            f"an unanswered request wedges the DU FIFO")
    return None
