"""The paper's §8 benchmark suite, restructured for the DAE IR.

Nine irregular kernels from the graph/data-analytics domain (§8.1.2), plus
two frontend-authored families (``repro.frontend`` — PR 9) that exercise
sequential sibling loops.  Where the paper replaced dynamically-growing
structures with HLS library equivalents, we restructure to bounded,
loop-based forms (edge-centric BFS / Bellman-Ford instead of queue/heap
versions — §4's honest limitation on φ-carried data LoD applies
identically to both systems):

=========  =====================================================  ==========
kernel     form                                                   decoupled
=========  =====================================================  ==========
hist       if (H[b[i]] < MAX) H[b[i]] += w[i]                     H
thr        if (img[3i] > T) img[3i..3i+2] = 0    (3 poisons)      img
mm         maximal matching: nested if on match[u], match[N+v]    match
fw         Floyd–Warshall, if (d[ik]+d[kj] < d[ij]) d[ij] = t     d
sort       bitonic net over precomputed (lo,hi,dir) pairs         a
spmv       if (V[col[j]] != 0) V[N+row[j]] += val[j]*V[col[j]]    V
bfs        edge-centric level-sync BFS on dist                    dist
sssp       edge-centric Bellman–Ford rounds                       dist
bc         BFS levels + sigma path counts (two LSQs, as paper)    dist,sigma
pagerank   push-pull fixed-point PageRank (frontend-authored)     R,C
join       hash join + group-by aggregate (frontend-authored)     HT,G
=========  =====================================================  ==========
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Set

import numpy as np

from ..core.ir import Function


@dataclass
class BenchCase:
    name: str
    fn: Function
    memory: Dict[str, np.ndarray]
    decoupled: Set[str]
    params: Dict[str, Any] = field(default_factory=dict)
    note: str = ""


from . import (hist, thr, mm, fw, sort as sort_b, spmv, bfs, sssp, bc,  # noqa: E402
               pagerank, join)

ALL = {
    "bfs": bfs.build,
    "bc": bc.build,
    "sssp": sssp.build,
    "hist": hist.build,
    "thr": thr.build,
    "mm": mm.build,
    "fw": fw.build,
    "sort": sort_b.build,
    "spmv": spmv.build,
    "pagerank": pagerank.build,
    "join": join.build,
}
