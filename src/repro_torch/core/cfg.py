"""CFG analyses used by the paper's transforms (§3.2 compiler preliminaries).

Dominators (iterative Cooper–Harvey–Kennedy), post-dominators over a
virtual-exit-augmented reverse CFG, Ferrante-style control dependence,
back-edge classification / reducibility, natural loops, reverse post-order of
the forward-edge DAG (the topological order of §5.1.3), forward reachability
ignoring back edges, and all-paths enumeration over a loop-body DAG with inner
loops collapsed (§5.1: "we do not enter loops other than the innermost loop
containing srcBB").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .ir import Function

VIRTUAL_EXIT = "__exit__"


# ---------------------------------------------------------------------------
# Dominance
# ---------------------------------------------------------------------------


def _dominators(succs: Dict[str, Sequence[str]], entry: str) -> Dict[str, Optional[str]]:
    """Immediate dominators; iterative algorithm over RPO."""
    # post-order DFS
    order: List[str] = []
    seen: Set[str] = set()

    def dfs(n: str) -> None:
        seen.add(n)
        for s in succs.get(n, ()):  # deterministic: succ order as given
            if s not in seen:
                dfs(s)
        order.append(n)

    dfs(entry)
    rpo = list(reversed(order))
    index = {b: i for i, b in enumerate(rpo)}
    preds: Dict[str, List[str]] = {b: [] for b in rpo}
    for b in rpo:
        for s in succs.get(b, ()):
            if s in index:
                preds[s].append(b)

    idom: Dict[str, Optional[str]] = {b: None for b in rpo}
    idom[entry] = entry

    def intersect(a: str, b: str) -> str:
        while a != b:
            while index[a] > index[b]:
                a = idom[a]  # type: ignore[assignment]
            while index[b] > index[a]:
                b = idom[b]  # type: ignore[assignment]
        return a

    changed = True
    while changed:
        changed = False
        for b in rpo:
            if b == entry:
                continue
            new: Optional[str] = None
            for p in preds[b]:
                if idom[p] is not None:
                    new = p if new is None else intersect(new, p)
            if new is not None and idom[b] != new:
                idom[b] = new
                changed = True
    idom[entry] = None
    return idom


@dataclass
class CFGInfo:
    """All analyses for one function, computed eagerly at construction."""

    fn: Function
    succs: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    preds: Dict[str, List[str]] = field(default_factory=dict)
    idom: Dict[str, Optional[str]] = field(default_factory=dict)
    ipdom: Dict[str, Optional[str]] = field(default_factory=dict)
    back_edges: Set[Tuple[str, str]] = field(default_factory=set)
    loops: Dict[str, Set[str]] = field(default_factory=dict)  # header -> body
    loop_latch: Dict[str, str] = field(default_factory=dict)  # header -> latch
    control_deps: Dict[str, Set[str]] = field(default_factory=dict)  # blk -> branch blocks

    def __post_init__(self) -> None:
        fn = self.fn
        self.succs = {b: tuple(fn.succs(b)) for b in fn.blocks}
        self.preds = fn.preds_map()
        self.idom = _dominators(self.succs, fn.entry)

        # back edges: target dominates source (reducible CFG assumption)
        for b, ss in self.succs.items():
            for s in ss:
                if self._dominates_idom(self.idom, s, b):
                    self.back_edges.add((b, s))
        # reducibility check: every retreating edge must be a back edge.
        self._check_reducible()

        # natural loops
        for (latch, header) in self.back_edges:
            body = self.loops.setdefault(header, {header})
            if header in self.loop_latch and self.loop_latch[header] != latch:
                raise ValueError(
                    f"loop {header} has two latches; canonicalize first")
            self.loop_latch[header] = latch
            stack = [latch]
            while stack:
                n = stack.pop()
                if n in body:
                    continue
                body.add(n)
                stack.extend(self.preds[n])

        # post-dominators via reversed graph + virtual exit
        rsuccs: Dict[str, List[str]] = {b: [] for b in fn.blocks}
        rsuccs[VIRTUAL_EXIT] = []
        for b, ss in self.succs.items():
            for s in ss:
                rsuccs[s].append(b)
        for b, blk in fn.blocks.items():
            if blk.term.kind == "ret":
                rsuccs[VIRTUAL_EXIT].append(b)
        self.ipdom = _dominators(
            {b: tuple(s) for b, s in rsuccs.items()}, VIRTUAL_EXIT)

        # control dependence (Ferrante): for edge (u, v) with |succ(u)| > 1,
        # every block on the pdom-tree path v .. ipdom(u) (exclusive) is
        # control dependent on u.
        self.control_deps = {b: set() for b in fn.blocks}
        for u, ss in self.succs.items():
            if len(set(ss)) < 2:
                continue
            stop = self.ipdom.get(u)
            for v in set(ss):
                runner: Optional[str] = v
                while runner is not None and runner != stop:
                    self.control_deps.setdefault(runner, set()).add(u)
                    runner = self.ipdom.get(runner)

    # -- dominance helpers ---------------------------------------------------
    @staticmethod
    def _dominates_idom(idom: Dict[str, Optional[str]], a: str, b: str) -> bool:
        runner: Optional[str] = b
        while runner is not None:
            if runner == a:
                return True
            nxt = idom.get(runner)
            if nxt == runner:
                return False
            runner = nxt
        return False

    def dominates(self, a: str, b: str) -> bool:
        return self._dominates_idom(self.idom, a, b)

    def post_dominates(self, a: str, b: str) -> bool:
        return self._dominates_idom(self.ipdom, a, b)

    def _check_reducible(self) -> None:
        # retreating edges found by DFS; all must be back edges
        seen: Set[str] = set()
        on_stack: Set[str] = set()

        def dfs(n: str) -> None:
            seen.add(n)
            on_stack.add(n)
            for s in self.succs.get(n, ()):
                if s not in seen:
                    dfs(s)
                elif s in on_stack and (n, s) not in self.back_edges:
                    raise ValueError(
                        f"irreducible CFG: retreating edge {n}->{s} is not a "
                        f"back edge (apply node splitting first)")
            on_stack.discard(n)

        dfs(self.fn.entry)

    # -- forward DAG queries ---------------------------------------------------
    def forward_succs(self, b: str) -> Tuple[str, ...]:
        return tuple(s for s in self.succs[b] if (b, s) not in self.back_edges)

    def reachable_forward(self, src: str, dst: str) -> bool:
        """Reachability following forward edges only (§5.2: 'reachability
        ignores loop backedges')."""
        if src == dst:
            return True
        stack, seen = [src], {src}
        while stack:
            n = stack.pop()
            for s in self.forward_succs(n):
                if s == dst:
                    return True
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return False

    def innermost_loop(self, b: str) -> Optional[str]:
        """Header of the innermost natural loop containing ``b``."""
        best: Optional[str] = None
        for h, body in self.loops.items():
            if b in body:
                if best is None or len(self.loops[h]) < len(self.loops[best]):
                    best = h
        return best

    # -- §5.1 region: loop-body DAG from srcBB, inner loops collapsed ----------
    def region_succs(self, header: Optional[str]) -> Dict[str, Tuple[str, ...]]:
        """Forward-edge successor map restricted to ``header``'s loop body
        (whole function if None), with inner-loop headers treated as opaque
        super-nodes: an edge into an inner loop jumps to that loop's header
        node, whose region successors are the inner loop's forward exits.
        """
        body = self.loops[header] if header else set(self.fn.blocks)
        inner_headers = {h for h in self.loops
                         if h != header and h in body and
                         (header is None or self.loops[h] < self.loops[header])}
        out: Dict[str, Tuple[str, ...]] = {}
        for b in body:
            inner = self._owning_inner(b, inner_headers)
            if inner is not None and inner != b:
                continue  # interior of a collapsed inner loop: not a node
            if inner == b:
                # super-node: successors are the inner loop's exits
                exits: List[str] = []
                for n in self.loops[b]:
                    for s in self.forward_succs(n):
                        if s not in self.loops[b] and s in body:
                            exits.append(s)
                out[b] = tuple(dict.fromkeys(exits))
            else:
                ss = []
                for s in self.forward_succs(b):
                    if s not in body:
                        continue
                    owner = self._owning_inner(s, inner_headers)
                    ss.append(owner if owner else s)
                out[b] = tuple(dict.fromkeys(ss))
        return out

    def _owning_inner(self, b: str, inner_headers: Set[str]) -> Optional[str]:
        best: Optional[str] = None
        for h in inner_headers:
            if b in self.loops[h]:
                if best is None or len(self.loops[h]) < len(self.loops[best]):
                    best = h
        return best

    def region_rpo(self, src: str, header: Optional[str]) -> List[str]:
        """Reverse post-order (= a topological order, §5.1.3) of the region
        DAG reachable from ``src`` inside ``header``'s loop."""
        succs = self.region_succs(header)
        order: List[str] = []
        seen: Set[str] = set()

        def dfs(n: str) -> None:
            seen.add(n)
            for s in succs.get(n, ()):
                if s not in seen:
                    dfs(s)
            order.append(n)

        dfs(src)
        return list(reversed(order))

    def region_paths(self, src: str, header: Optional[str]) -> Iterator[List[str]]:
        """All paths from ``src`` to the loop latch (or any ret block when
        ``header`` is None) over the region DAG (Algorithm 2 line 4)."""
        succs = self.region_succs(header)
        sinks = ({self.loop_latch[header]} if header else
                 {b for b, blk in self.fn.blocks.items() if blk.term.kind == "ret"})

        path: List[str] = [src]

        def rec(n: str) -> Iterator[List[str]]:
            if n in sinks or not succs.get(n, ()):
                yield list(path)
                return
            for s in succs[n]:
                path.append(s)
                yield from rec(s)
                path.pop()

        yield from rec(src)

    def region_reachable(self, src: str, dst: str, header: Optional[str]) -> bool:
        succs = self.region_succs(header)
        if src == dst:
            return True
        stack, seen = [src], {src}
        while stack:
            n = stack.pop()
            for s in succs.get(n, ()):
                if s == dst:
                    return True
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return False
