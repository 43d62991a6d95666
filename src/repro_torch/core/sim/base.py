"""Shared machine-model types: configuration, results, sentinels.

These are the public API surface re-exported by :mod:`repro_torch.core.machine`;
the event-driven engine (``events``/``fifo``/``units``) builds on them.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def _env_batch_window() -> bool:
    """Opt-in default for batch-window execution (``DAE_SIM_WINDOW=1``)."""
    return _env_flag("DAE_SIM_WINDOW")


def _env_pipeline_window() -> bool:
    """Opt-in default for steady-state pipeline windows
    (``DAE_SIM_PIPELINE=1``)."""
    return _env_flag("DAE_SIM_PIPELINE")


@dataclass
class MachineConfig:
    mem_lat: int = 4           # on-chip SRAM read latency (pipelined, §8.1)
    fifo_lat: int = 4          # FIFO traversal latency (inter-unit crossing)
    fifo_depth: int = 8        # request/value FIFO capacity
    ldq: int = 4               # LSQ load-queue entries (paper §8.1)
    stq: int = 32              # LSQ store-queue entries (paper §8.1)
    width: int = 4             # per-slice instructions retired per cycle
    sta_width: int = 8         # STA issue width (spatial datapath ILP)
    max_cycles: int = 20_000_000
    # batch-window execution: when every other unit is provably quiet until
    # cycle T, the sole runnable slice process advances through [now, T) in
    # one step instead of one event per cycle.  Bit-identical to the
    # event-stepped and cycle-stepped models (tests/test_sim_equivalence.py);
    # opt in per-config or machine-wide via DAE_SIM_WINDOW=1.
    batch_window: bool = field(default_factory=_env_batch_window)
    # steady-state pipeline windows: extends the window theorem from "sole
    # runnable slice" to multi-unit grants — a sole-runnable LSQ advances
    # through its stretch with the compiled run-tick (batched retirement
    # and commit runs), and stretches where >=2 units are runnable
    # every cycle (the load-dense steady pattern: AGU pushing, CU
    # consuming, LSQ retiring one load per cycle) run under a single grant
    # in the steady regime loop.  Implies slice batch windows.  Opt in
    # per-config or machine-wide via DAE_SIM_PIPELINE=1; bit-identical to
    # all other engines (tests/test_sim_equivalence.py).
    pipeline_window: bool = field(default_factory=_env_pipeline_window)


@dataclass
class MachineResult:
    cycles: int
    stores_committed: int = 0
    stores_poisoned: int = 0
    loads_served: int = 0
    sync_waits: int = 0
    store_trace: Dict[str, List[Tuple[int, Any]]] = field(default_factory=dict)
    lsq_high_water: int = 0
    # window statistics, split by kind (diagnostic only — never part of
    # the bit-exactness contract).  Quiescent windows: a sole-runnable
    # slice consumed the stretch itself (the batch windows).  Pipeline
    # windows: a multi-unit steady-state grant — either the compiled LSQ
    # run-tick advanced a sole-runnable LSQ, or the steady regime loop
    # carried the whole runnable unit set through the stretch.
    window_grants: int = 0
    window_cycles: int = 0
    pipeline_grants: int = 0
    pipeline_cycles: int = 0

    @property
    def misspec_rate(self) -> float:
        tot = self.stores_committed + self.stores_poisoned
        return self.stores_poisoned / tot if tot else 0.0

    @property
    def window_hit_rate(self) -> float:
        """Fraction of simulated cycles covered by any window kind."""
        if not self.cycles:
            return 0.0
        return (self.window_cycles + self.pipeline_cycles) / self.cycles

    @property
    def quiescent_hit_rate(self) -> float:
        """Fraction of simulated cycles consumed inside slice windows."""
        return self.window_cycles / self.cycles if self.cycles else 0.0

    @property
    def pipeline_hit_rate(self) -> float:
        """Fraction of simulated cycles covered by pipeline windows."""
        return self.pipeline_cycles / self.cycles if self.cycles else 0.0


class Deadlock(RuntimeError):
    pass


POISON = object()  # kill-token sentinel in the store-value FIFO
