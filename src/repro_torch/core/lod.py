"""Loss-of-decoupling analysis (paper §4).

Given a function and the set of *decoupled* arrays (those whose accesses go
through the DU), classify every memory request:

* **data LoD** (Def. 4.1) — the request's *address* def-use cone reaches a
  decoupled load (including the φ/terminator rule: a φ on the chain also
  taints through the terminators of its incoming blocks).  Not speculable;
  the request stays synchronized (paper: `A[f(A[i])]`, `if (A[i]) A[i++]`).
* **control LoD** (Def. 4.2) — the request is (iterated-)control-dependent on
  a branch whose condition depends on a decoupled load.  Speculable via
  Algorithms 1–3.  The *sources* are the blocks containing such branches; for
  nested LoD chains only the **chain heads** (§5.1.2) are hoist targets.

Every memory instruction gets a stable id ``meta['mid']`` so the AGU/CU
slices produced later can be correlated with this analysis.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Set, Tuple

from .cfg import CFGInfo
from .ir import Function, Instr, MEMORY_OPS


def tag_mids(fn: Function) -> Dict[int, Instr]:
    """Assign stable ids to memory instructions; returns mid -> Instr."""
    mids: Dict[int, Instr] = {}
    n = 0
    for blk in fn.blocks.values():
        for i in blk.instructions():
            if i.op in MEMORY_OPS:
                if "mid" not in i.meta:
                    i.meta["mid"] = n
                mids[i.meta["mid"]] = i
                n = max(n + 1, i.meta["mid"] + 1)
    return mids


@dataclass
class LoDInfo:
    fn: Function
    cfg: CFGInfo
    decoupled: Set[str]
    #: value names transitively dependent on decoupled-load values
    tainted: Set[str] = field(default_factory=set)
    #: mid -> block name (original position)
    request_block: Dict[int, str] = field(default_factory=dict)
    #: mids whose *address* has a data LoD (Def 4.1) — not speculable
    data_lod: Set[int] = field(default_factory=set)
    #: mid -> all LoD control-dependency source blocks (Def 4.2)
    control_sources: Dict[int, Set[str]] = field(default_factory=dict)
    #: mid -> chain-head hoist targets (§5.1.2); empty => not speculative
    chain_heads: Dict[int, Set[str]] = field(default_factory=dict)
    #: all LoD source blocks (any request)
    src_blocks: Set[str] = field(default_factory=set)
    #: branch blocks whose condition is tainted
    tainted_branches: Set[str] = field(default_factory=set)


def analyze(fn: Function, decoupled: Set[str]) -> LoDInfo:
    cfg = CFGInfo(fn)
    info = LoDInfo(fn, cfg, set(decoupled))
    tag_mids(fn)

    defs: Dict[str, Tuple[str, Instr]] = {}
    for bname, blk in fn.blocks.items():
        for i in blk.instructions():
            if i.dest is not None:
                defs[i.dest] = (bname, i)

    # ---- taint propagation from decoupled loads (Def 4.1 incl. φ rule) ----
    # A = loads from decoupled arrays that can have a RAW hazard, i.e. the
    # array is also stored somewhere in the function (paper §4: loads needing
    # memory disambiguation).  Read-only decoupled loads prefetch trivially.
    stored_arrays = {i.array for blk in fn.blocks.values()
                     for i in blk.body if i.op == "store"}
    raw_load_dests = {
        i.dest for blk in fn.blocks.values() for i in blk.body
        if i.op == "load" and i.array in decoupled and i.array in stored_arrays
    }

    tainted: Set[str] = set(raw_load_dests)
    changed = True
    while changed:
        changed = False
        for bname, blk in fn.blocks.items():
            for i in blk.instructions():
                if i.dest is None or i.dest in tainted:
                    continue
                hit = any(u in tainted for u in i.uses())
                if not hit and i.op == "phi":
                    # φ rule: terminators of incoming blocks on the chain
                    for (pb, _) in i.args:
                        t = fn.blocks[pb].term
                        if t.cond is not None and t.cond in tainted:
                            hit = True
                            break
                if hit:
                    tainted.add(i.dest)
                    changed = True
    info.tainted = tainted

    info.tainted_branches = {
        bname for bname, blk in fn.blocks.items()
        if blk.term.cond is not None and blk.term.cond in tainted
    }

    # ---- classify each request -------------------------------------------
    for bname, blk in fn.blocks.items():
        for i in blk.body:
            if i.op not in ("load", "store") or i.array not in decoupled:
                continue
            mid = i.meta["mid"]
            info.request_block[mid] = bname
            addr = i.args[0]
            if isinstance(addr, str) and addr in tainted:
                info.data_lod.add(mid)
                continue
            # iterated control dependence upward from the request's block
            sources = _iterated_lod_sources(cfg, bname, info.tainted_branches)
            if sources:
                info.control_sources[mid] = sources
                info.src_blocks |= sources

    # ---- chain heads (§5.1.2) ---------------------------------------------
    # an LoD source block is excluded if it is itself (iterated-)control-
    # dependent on another LoD source block.
    heads_global = {
        s for s in info.src_blocks
        if not (_iterated_lod_sources(cfg, s, info.tainted_branches)
                & (info.src_blocks - {s}))
    }
    for mid, sources in info.control_sources.items():
        bname = info.request_block[mid]
        heads = set()
        for h in sources & heads_global:
            heads.add(h)
        # requests whose direct sources are all non-heads inherit the heads
        # of their chain (Fig. 4: e@7 depends on 5, chains to heads 2 and 3)
        frontier = list(sources - heads_global)
        seen = set(frontier)
        while frontier:
            s = frontier.pop()
            up = _iterated_lod_sources(cfg, s, info.tainted_branches)
            for u in up:
                if u in heads_global:
                    heads.add(u)
                elif u not in seen:
                    seen.add(u)
                    frontier.append(u)
        # only heads from which the request block is region-reachable matter
        loop = cfg.innermost_loop(bname)
        heads = {h for h in heads
                 if cfg.innermost_loop(h) == loop
                 and cfg.region_reachable(h, bname, loop)}
        info.chain_heads[mid] = heads
    return info


def _iterated_lod_sources(cfg: CFGInfo, bname: str,
                          tainted_branches: Set[str]) -> Set[str]:
    """All tainted-branch blocks in the iterated control-dependence closure
    of ``bname`` (Def 4.2's 'need not be the immediate control dependency')."""
    out: Set[str] = set()
    frontier = [bname]
    seen: Set[str] = set(frontier)
    while frontier:
        b = frontier.pop()
        for dep in cfg.control_deps.get(b, ()):  # branch blocks
            if dep in tainted_branches:
                out.add(dep)
            if dep not in seen:
                seen.add(dep)
                frontier.append(dep)
    return out


def speculable(info: LoDInfo, mid: int) -> Tuple[bool, str]:
    """Can this request be speculated (Alg. 1)?  Returns (ok, reason).

    Beyond the paper's statement we enforce the *partition property* needed
    by Lemma 6.1 (DESIGN.md §8): the chain heads must tile all paths to the
    request — (a) no head reaches another head, (b) the request block is
    unreachable when all heads are removed, (c) request and heads live in the
    same innermost loop (no inner-loop requests, §5.1).
    """
    if mid in info.data_lod:
        return False, "data-LoD (Def 4.1): address depends on decoupled load"
    heads = info.chain_heads.get(mid) or set()
    if not heads:
        return False, "no control-LoD sources (request is non-speculative)"
    cfg = info.cfg
    bname = info.request_block[mid]
    loop = cfg.innermost_loop(bname)
    for h in heads:
        if cfg.innermost_loop(h) != loop:
            return False, f"head {h} not in request's innermost loop"
    hs = sorted(heads)
    for a in hs:
        for b in hs:
            if a != b and cfg.region_reachable(a, b, loop):
                return False, f"heads {a} and {b} lie on one path"
    # (b): remove heads, check unreachability from loop header (or entry)
    start = loop if loop else info.fn.entry
    succs = cfg.region_succs(loop)
    stack, seen = [start], {start}
    while stack:
        n = stack.pop()
        if n in heads:
            continue
        for s in succs.get(n, ()):
            if s == bname:
                return False, "a path reaches the request bypassing all heads"
            if s not in seen:
                seen.add(s)
                stack.append(s)
    return True, "ok"
