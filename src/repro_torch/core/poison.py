"""Algorithms 2 + 3 and §5.3 (paper): poisoning mis-speculated stores in the CU.

**Algorithm 2** maps each speculated store to the CFG *edges* where it must be
poisoned: walking every path from the speculation block to the loop latch with
the pending request list (in AGU hoist order), a request is

* *consumed* when the edge destination is its trueBB,
* *poisoned* on the first edge whose destination can no longer reach its
  trueBB — but only once every earlier pending request has been resolved
  (this is the order-matching heart of the paper, §2/§5.2),
* otherwise left pending for a later edge.

Requests still pending when the path ends (e.g. their predecessors' trueBB
was the latch itself) drain onto a virtual end-of-latch edge — poison calls
append after the latch body, i.e. execute on the backedge (DESIGN.md §8).

**Algorithm 3** materializes the per-edge poison lists into blocks.  We use
the paper's cases 1/2 (new block on the edge; φ-steering when the speculation
block does not dominate the edge destination) and deliberately *skip* the
case-3 "prepend into edge_dst" optimization: a prepend is shared by all
incoming edges of the destination and can double-poison a path that already
resolved the request on an earlier edge (DESIGN.md §8 has the counterexample).
Edge blocks are always sound; the §5.3 merging pass recovers the block count.

Steering uses one mutable flag per speculation block — ``setreg 0`` in the
loop header, ``setreg 1`` at the end of specBB — the operational form of
Algorithm 3's ``phi(1, specBB)`` web.  Poison blocks are marked
``synthetic``: dynamic φ-predecessor resolution looks through them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .cfg import CFGInfo
from .ir import Function, Instr
from .speculation import SpecResult

END = "__end__"  # virtual edge destination: append at end of source block


@dataclass
class PoisonStats:
    poison_calls: int = 0
    poison_blocks: int = 0
    merged_blocks: int = 0
    steered_groups: int = 0


def poison_cu(cu: Function, cfg: CFGInfo, spec: SpecResult,
              array_of: Dict[int, str]) -> PoisonStats:
    """Insert poison calls into the CU (Algorithms 2+3, then §5.3 merging).

    ``cfg`` is the analysis of the *original* function — the CU still has the
    same block structure here.  ``array_of``: store mid -> array name (the
    poison token goes to that array's store-value FIFO).
    """
    stats = PoisonStats()

    # ---- Algorithm 2: ordered poison slots per region edge -----------------
    edge_slots: Dict[Tuple[str, str], List[Tuple[int, str]]] = {}
    edge_seen: Dict[Tuple[str, str], Set[int]] = {}

    def emit(u: str, v: str, mid: int, spec_bb: str) -> None:
        key = (u, v)
        if mid in edge_seen.setdefault(key, set()):
            return  # Alg. 3 runs once per (edge, r)
        edge_seen[key].add(mid)
        edge_slots.setdefault(key, []).append((mid, spec_bb))

    # The pending walk runs PER ARRAY: only same-array token order is a FIFO
    # constraint, and a still-reachable front request of one array must not
    # defer another array's poison past that array's next produce.
    for spec_bb in sorted(spec.spec_req_map):
        loop = cfg.innermost_loop(spec_bb)
        arrays = sorted({array_of[m] for m in spec.spec_req_map[spec_bb]})
        for arr in arrays:
            requests = [m for m in spec.spec_req_map[spec_bb]
                        if array_of[m] == arr]
            for path in cfg.region_paths(spec_bb, loop):
                pending: List[int] = list(requests)
                for u, v in zip(path, path[1:]):
                    while pending:
                        mid = pending[0]
                        tb = spec.true_block[mid]
                        if tb == v:
                            # consumed at its trueBB (value produced there);
                            # same-block requests are consecutive in order
                            while pending and spec.true_block[pending[0]] == v:
                                pending.pop(0)
                            break  # to the next edge
                        if not cfg.region_reachable(v, tb, loop):
                            emit(u, v, mid, spec_bb)
                            pending.pop(0)
                            continue
                        break  # earliest pending still live: next edge
                for mid in pending:  # drain at path end
                    if spec.true_block[mid] != path[-1]:
                        emit(path[-1], END, mid, spec_bb)

    # ---- Algorithm 3 (cases 1/2 unified): materialize ----------------------
    steer_specs: Set[str] = set()
    for (u, v) in sorted(edge_slots):
        slots = edge_slots[(u, v)]
        for (ru, rv) in _real_edges(cfg, u, v):
            _materialize(cu, cfg, ru, rv, slots, array_of, steer_specs, stats)

    # ---- steering flag maintenance ------------------------------------------
    for spec_bb in sorted(steer_specs):
        loop = cfg.innermost_loop(spec_bb)
        reset_block = loop if loop else cu.entry
        cu.blocks[reset_block].body.insert(
            0, Instr("setreg", None, (f"steer.{spec_bb}",), None, {"imm": 0}))
        cu.blocks[spec_bb].body.append(
            Instr("setreg", None, (f"steer.{spec_bb}",), None, {"imm": 1}))

    # ---- §5.3: merge equivalent poison blocks -------------------------------
    stats.merged_blocks = merge_poison_blocks(cu)
    stats.poison_blocks = sum(1 for b in cu.blocks.values() if b.synthetic)
    return stats


# ---------------------------------------------------------------------------


def _real_edges(cfg: CFGInfo, u: str, v: str) -> List[Tuple[str, str]]:
    """Expand a region-DAG edge into concrete CFG edges (inner-loop
    super-nodes expand to their exit edges)."""
    if v == END:
        return [(u, END)]
    if u in cfg.loops and v not in cfg.succs.get(u, ()):
        out = []
        for n in cfg.loops[u]:
            if v in cfg.forward_succs(n):
                out.append((n, v))
        if out:
            return out
    return [(u, v)]


def _materialize(cu: Function, cfg: CFGInfo, u: str, v: str,
                 slots: Sequence[Tuple[int, str]], array_of: Dict[int, str],
                 steer_specs: Set[str], stats: PoisonStats) -> None:
    """Place ordered poison slots on edge (u, v), or at end of u for END.

    Steering (Alg. 3 case 2) is keyed on the edge *source*: the poison block
    lives on the edge, so if specBB dominates ``u`` every traversal of the
    edge provably passed the speculation — slightly sharper than the paper's
    edge_dst formulation, same soundness argument.
    """
    groups: List[Tuple[Optional[str], List[int]]] = []
    for mid, spec_bb in slots:
        steer = None if cfg.dominates(spec_bb, u) else spec_bb
        if groups and groups[-1][0] == steer:
            groups[-1][1].append(mid)
        else:
            groups.append((steer, [mid]))
    stats.poison_calls += len(slots)

    if v == END:
        for steer, mids in groups:
            pred = None
            if steer is not None:
                steer_specs.add(steer)
                pred = f"steer.{steer}"
                stats.steered_groups += 1
            cu.blocks[u].body.extend(_poisons(mids, array_of, pred))
        return

    # build the block chain back-to-front so each group branches onward
    target = v
    for steer, mids in reversed(groups):
        if steer is None:
            nb = cu.block(cu.fresh(f"poison.{u}.{v}"))
            nb.synthetic = True
            nb.body.extend(_poisons(mids, array_of, None))
            nb.br(target)
            target = nb.name
        else:
            steer_specs.add(steer)
            stats.steered_groups += 1
            pb = cu.block(cu.fresh(f"poison.{u}.{v}.s"))
            pb.synthetic = True
            pb.body.extend(_poisons(mids, array_of, None))
            pb.br(target)
            chk = cu.block(cu.fresh(f"steer.{u}.{v}"))
            chk.synthetic = True
            flag = cu.fresh("steer")
            chk.body.append(Instr("getreg", flag, (f"steer.{steer}",)))
            chk.cbr(flag, pb.name, target)
            target = chk.name
    cu.blocks[u].term.retarget(v, target)


def _poisons(mids: Sequence[int], array_of: Dict[int, str],
             pred_reg: Optional[str]) -> List[Instr]:
    out = []
    for mid in mids:
        meta = {"mid": mid, "poison": True}
        if pred_reg:
            meta["pred_reg"] = pred_reg
        out.append(Instr("poison_st", None, (), array_of[mid], meta))
    return out


# ---------------------------------------------------------------------------
# §5.3 — merging poison blocks
# ---------------------------------------------------------------------------


def merge_poison_blocks(cu: Function) -> int:
    """Merge synthetic blocks with identical instructions and successors."""
    merged = 0
    changed = True
    while changed:
        changed = False
        sig: Dict[Tuple, str] = {}
        preds = cu.preds_map()
        for name in list(cu.blocks):
            blk = cu.blocks[name]
            if not blk.synthetic or blk.phis:
                continue
            key = (tuple((i.op, i.array, i.meta.get("mid"),
                          i.meta.get("pred_reg"),
                          tuple(i.args) if i.op != "getreg" else (i.args[0],))
                         for i in blk.body),
                   blk.term.kind,
                   blk.term.targets)
            if key in sig and sig[key] != name:
                keep = sig[key]
                for p in preds.get(name, ()):
                    cu.blocks[p].term.retarget(name, keep)
                del cu.blocks[name]
                merged += 1
                changed = True
                break
            sig[key] = name
    return merged
