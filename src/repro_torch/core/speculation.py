"""Algorithm 1 (paper §5.1): control-flow hoisting of AGU requests.

For every chain-head LoD source block ``srcBB``, hoist each speculable
request that chains to it to the end of ``srcBB``, in **reverse post-order**
(= topological order) of the loop-body DAG from ``srcBB`` (§5.1.3).  A
request hoisted to multiple heads (Fig. 4: b → blocks 2 *and* 3) is cloned
into each; the partition property validated by :func:`repro.core.lod.
speculable` guarantees exactly one clone fires per iteration.

The request's *address cone* (pure computation feeding the request index)
is cloned alongside when it does not dominate the hoist target — the IR-level
equivalent of LLVM rematerializing speculatable address arithmetic.

§5.4: for speculated loads, the CU's matching ``consume_ld`` is hoisted to
the same block in the same relative order, keeping the per-array load-value
FIFO aligned with the AGU's request FIFO.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .cfg import CFGInfo
from .ir import Function, Instr
from . import lod as lod_mod


@dataclass
class SpecResult:
    #: specBB -> ordered list of hoisted store mids (Alg. 2 input)
    spec_req_map: Dict[str, List[int]] = field(default_factory=dict)
    #: specBB -> ordered list of *all* hoisted mids (loads + stores)
    spec_all_map: Dict[str, List[int]] = field(default_factory=dict)
    #: mid -> original block (trueBB for stores)
    true_block: Dict[int, str] = field(default_factory=dict)
    #: mid -> set of heads it was hoisted to
    hoisted_to: Dict[int, Set[str]] = field(default_factory=dict)
    #: mids that failed the speculable() guard, with reasons
    fallback: Dict[int, str] = field(default_factory=dict)
    #: number of speculative request instructions added to the AGU
    spec_requests: int = 0


def speculate(agu: Function, cu: Function, info: lod_mod.LoDInfo) -> SpecResult:
    """Apply Algorithm 1 to ``agu`` (and §5.4 consume-hoisting to ``cu``).

    Both slices must still have the original CFG shape (run before
    ``finalize_agu``).  Returns the SpecReqMap for Algorithms 2/3.
    """
    res = SpecResult()
    cfg = info.cfg  # analyses of the original fn; same shape as agu/cu here

    agu_by_mid = _index_by_mid(agu)
    cu_by_mid = _index_by_mid(cu)
    intra = _intra_positions(agu)
    defs = _defs(agu)
    stored = {i.array for b in agu.blocks.values() for i in b.body
              if i.op in ("store", "send_st")}

    # -- phase 1: decide which requests hoist where --------------------------
    per_head: Dict[str, List[int]] = {}
    for mid in sorted(info.control_sources):
        ok, why = lod_mod.speculable(info, mid)
        if ok:
            # every head must be able to receive the request's address cone
            for h in info.chain_heads[mid]:
                if not _cone_ok(agu, cfg, defs, stored, agu_by_mid[mid][1], h):
                    ok, why = False, f"address cone not speculatable to {h}"
                    break
        if not ok:
            res.fallback[mid] = why
            continue
        res.true_block[mid] = info.request_block[mid]
        res.hoisted_to[mid] = set(info.chain_heads[mid])
        for h in info.chain_heads[mid]:
            per_head.setdefault(h, []).append(mid)

    if not per_head:
        return res

    # -- phase 1.5: hoist-window hazard rule (DESIGN.md §8) ------------------
    # Hoisting r to h reorders it above every same-array request q whose
    # original position lies strictly between h and r.  That inverts the
    # per-array FIFO hazard order (RAW/WAR/WAW) unless q is hoisted to h too
    # — and a *load* r hoisted above a same-array *store* q deadlocks the CU
    # (its hoisted consume precedes the produce the DU is waiting on).  The
    # paper's benchmarks never hit these shapes; we refuse them explicitly.
    _apply_hazard_rule(agu_by_mid, cfg, info, per_head, res)
    per_head = {h: v for h, v in per_head.items() if v}
    if not per_head:
        return res

    # -- phase 2: hoist, per head, in topological order (§5.1.3) -------------
    # Ties between path-incomparable requests are broken loads-first: the DU
    # serves requests in arrival order, so a store placed (arbitrarily) ahead
    # of a path-exclusive load would stall that load on address collision
    # while the CU's hoisted consume precedes the store's produce — deadlock.
    hoisted: Set[int] = set()
    for h in sorted(per_head):
        loop = cfg.innermost_loop(h)
        topo_pos = {b: i for i, b in enumerate(cfg.region_rpo(h, loop))}
        mids = _kahn_order(cfg, info, agu_by_mid, intra, topo_pos,
                           per_head[h], loop)
        per_head[h] = mids

        rename: Dict[str, str] = {}
        for m in mids:
            _, instr = agu_by_mid[m]
            _clone_cone(agu, cfg, defs, instr, h, rename)
            clone = instr.clone()
            clone.args = tuple(rename.get(a, a) if isinstance(a, str) else a
                               for a in clone.args)
            clone.meta.update(speculative=True, spec_head=h)
            if clone.dest is not None:
                clone.meta["multi_def"] = True
            agu.blocks[h].body.append(clone)
            res.spec_requests += 1
            hoisted.add(m)

            # §5.4 — hoist the CU-side consume for speculated loads
            if instr.op == "send_ld":
                _, cu_instr = cu_by_mid[m]
                cclone = cu_instr.clone()
                cclone.meta.update(speculative=True, multi_def=True)
                cu.blocks[h].body.append(cclone)

        res.spec_all_map[h] = list(mids)
        res.spec_req_map[h] = [m for m in mids
                               if agu_by_mid[m][1].op == "send_st"]

    # -- phase 3: remove originals -------------------------------------------
    for m in hoisted:
        bname, instr = agu_by_mid[m]
        agu.blocks[bname].body.remove(instr)
        if instr.op == "send_ld":
            cb, ci = cu_by_mid[m]
            cu.blocks[cb].body.remove(ci)

    res.spec_req_map = {h: v for h, v in res.spec_req_map.items() if v}
    res.spec_all_map = {h: v for h, v in res.spec_all_map.items() if v}
    return res


# ---------------------------------------------------------------------------


def _kahn_order(cfg: CFGInfo, info, agu_by_mid, intra, topo_pos, mids,
                loop) -> List[int]:
    """Topological order of the hoist list, choosing loads before stores
    among unconstrained requests.  Only *same-array* per-path order is a
    constraint — each array has its own FIFOs/LSQ, so cross-array request
    order is free, and freeing it lets every load precede every store it
    isn't genuinely ordered after."""
    mids = list(mids)

    def before(a: int, b: int) -> bool:
        if agu_by_mid[a][1].array != agu_by_mid[b][1].array:
            return False  # independent FIFOs
        ba, bb = info.request_block[a], info.request_block[b]
        if ba == bb:
            return intra[a] < intra[b]
        return cfg.region_reachable(ba, bb, loop)

    succs = {m: [n for n in mids if n != m and before(m, n)] for m in mids}
    indeg = {m: 0 for m in mids}
    for m, ss in succs.items():
        for s in ss:
            indeg[s] += 1
    ready = [m for m in mids if indeg[m] == 0]
    out: List[int] = []
    while ready:
        # loads first among ready; stable by block topo position then intra
        ready.sort(key=lambda m: (agu_by_mid[m][1].op != "send_ld",
                                  topo_pos.get(info.request_block[m], 1 << 30),
                                  intra[m]))
        m = ready.pop(0)
        out.append(m)
        for s in succs[m]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    return out


def _apply_hazard_rule(agu_by_mid, cfg: CFGInfo, info, per_head, res) -> None:
    """Two refusal rules keeping the per-array FIFO orders realizable:

    (i)  a speculated *load* must not hoist above a same-array *store* that
         precedes it on some path (the CU's hoisted consume would precede the
         produce the DU needs -- deadlock on address collision);
    (ii) **all-or-none per (head, array)**: if any same-decoupled-array
         request in the region below a head stays unhoisted, no request on
         that array may hoist to that head.  Poisons live on block *edges*,
         so they cannot be interleaved between two produces inside one block
         -- which is what a hoisted request jumping an unhoisted one demands.

    Both are strictly stronger than anything the paper states; its benchmarks
    (and our framework uses) hoist whole conditional regions, so nothing is
    lost there.  DESIGN.md section 8 records both counterexamples.
    """
    requests = []  # (mid, array, is_store, block, intra_pos)
    for bname, blk in cfg.fn.blocks.items():
        for pos, instr in enumerate(blk.body):
            m = instr.meta.get("mid")
            if (m is not None and instr.op in ("load", "store")
                    and instr.array in info.decoupled):
                requests.append((m, instr.array, instr.op == "store",
                                 bname, pos))
    by_mid = {r[0]: r for r in requests}

    def refuse(r: int, why: str) -> None:
        for hh in res.hoisted_to.pop(r, set()):
            if r in per_head.get(hh, []):
                per_head[hh].remove(r)
        res.true_block.pop(r, None)
        res.fallback[r] = why

    # --- rule (i): path-ordered load-after-store ---------------------------
    changed = True
    while changed:
        changed = False
        for h in list(per_head):
            loop = cfg.innermost_loop(h)
            for r in list(per_head[h]):
                _, r_arr, r_store, r_blk, r_pos = by_mid[r]
                if r_store:
                    continue
                for (q, q_arr, q_store, q_blk, q_pos) in requests:
                    if q == r or q_arr != r_arr or not q_store or q_blk == h:
                        continue
                    between = (cfg.region_reachable(h, q_blk, loop)
                               and (cfg.region_reachable(q_blk, r_blk, loop)
                                    if q_blk != r_blk else q_pos < r_pos))
                    if between:
                        refuse(r, f"hazard(i) vs mid {q}: load hoisted over "
                                  f"same-array store")
                        changed = True
                        break

    # --- rule (ii): all-or-none per (head, array) --------------------------
    changed = True
    while changed:
        changed = False
        for h in list(per_head):
            loop = cfg.innermost_loop(h)
            hoisted_here = set(per_head[h])
            for arr in {by_mid[m][1] for m in per_head[h]}:
                region_reqs = [
                    q for (q, q_arr, _qs, q_blk, _qp) in requests
                    if q_arr == arr and q_blk != h
                    and cfg.innermost_loop(q_blk) == loop
                    and cfg.region_reachable(h, q_blk, loop)
                ]
                if any(q not in hoisted_here for q in region_reqs):
                    for r in [m for m in per_head[h]
                              if by_mid[m][1] == arr]:
                        refuse(r, f"hazard(ii): array {arr} not fully "
                                  f"hoistable at {h}")
                        changed = True


def _index_by_mid(fn: Function) -> Dict[int, Tuple[str, Instr]]:
    out: Dict[int, Tuple[str, Instr]] = {}
    for bname, blk in fn.blocks.items():
        for i in blk.body:
            if "mid" in i.meta:
                out[i.meta["mid"]] = (bname, i)
    return out


def _intra_positions(fn: Function) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for blk in fn.blocks.values():
        for pos, i in enumerate(blk.body):
            if "mid" in i.meta:
                out[i.meta["mid"]] = pos
    return out


def _defs(fn: Function) -> Dict[str, Tuple[str, Instr]]:
    defs: Dict[str, Tuple[str, Instr]] = {}
    for bname, blk in fn.blocks.items():
        for i in blk.instructions():
            if i.dest is not None and i.dest not in defs:
                defs[i.dest] = (bname, i)
    return defs


def _cone_walk(cfg: CFGInfo, defs: Dict[str, Tuple[str, Instr]],
               stored: Set[str], request: Instr, head: str):
    """Yield cone defs needing cloning, or raise ValueError if unhoistable."""
    seen: Set[str] = set()
    order: List[Instr] = []

    def visit(name: str) -> None:
        if name in seen:
            return
        seen.add(name)
        if name not in defs:
            return  # function param
        dblk, dinstr = defs[name]
        if cfg.dominates(dblk, head):
            return  # available at the head already
        if dinstr.op in ("phi", "consume_ld", "getreg") or dinstr.is_effect():
            raise ValueError(f"{name}: non-speculatable def ({dinstr.op})")
        if dinstr.op == "load" and dinstr.array in stored:
            raise ValueError(f"{name}: load from written array {dinstr.array}")
        for u in dinstr.uses():
            visit(u)
        order.append(dinstr)

    for u in request.uses():
        visit(u)
    return order


def _cone_ok(fn: Function, cfg: CFGInfo, defs, stored,
             request: Instr, head: str) -> bool:
    try:
        _cone_walk(cfg, defs, stored, request, head)
        return True
    except ValueError:
        return False


def _clone_cone(fn: Function, cfg: CFGInfo, defs, request: Instr, head: str,
                rename: Dict[str, str]) -> None:
    """Clone the request's address cone into ``head`` under fresh names so
    the originals can die with their guarding branch (restoring decoupling);
    ``rename`` accumulates old->fresh across requests hoisted to one head."""
    stored = {i.array for b in fn.blocks.values() for i in b.body
              if i.op in ("store", "send_st")}
    for d in _cone_walk(cfg, defs, stored, request, head):
        if d.dest in rename:
            continue
        c = d.clone()
        c.dest = fn.fresh(d.dest + ".spec")
        rename[d.dest] = c.dest
        if c.op == "bin":
            c.args = (c.args[0],) + tuple(
                rename.get(a, a) if isinstance(a, str) else a
                for a in c.args[1:])
        elif c.op != "const":
            c.args = tuple(rename.get(a, a) if isinstance(a, str) else a
                           for a in c.args)
        c.meta["spec_cone"] = True
        fn.blocks[head].body.append(c)
