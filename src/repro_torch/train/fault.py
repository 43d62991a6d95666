"""Fault tolerance & straggler mitigation for the 1000-node posture
(a copy of the JAX package's ``train/fault.py`` on the port's own
resilience plane).

This container has one process, so multi-host behaviour is expressed as
a **policy engine with injectable signals** (exercised by
``tests/test_torch_train.py`` with simulated failures) plus the pieces
that do run for real here: checkpoint/restart and elastic re-meshing.

Policies:

* **Heartbeats** — each host ticks; a host silent for ``dead_after`` seconds
  is declared dead → RESTART_ELASTIC (reload latest checkpoint on the
  surviving mesh; data pipeline seeks to the saved step — no data replay).
* **Stragglers** — per-step durations feed an EWMA; a host slower than
  ``straggler_factor``× the fleet median for ``patience`` consecutive steps
  is flagged for re-dispatch (its shard reassigned at the next barrier; the
  paper's discipline again: don't wait — speculate past it, reconcile at the
  barrier).
* **Elastic scaling** — `plan_remesh` maps a surviving device count to the
  largest fillable (data, model) mesh, keeping the model axis intact first
  (TP/EP shards are stateful; DP shrink only re-slices the batch);
  `remesh` builds that ``DeviceMesh``, and
  ``CheckpointManager.restore(shard_fn=...)`` with
  ``repro_torch.launch.mesh.distribute_params`` re-places a restored
  tree on it.

This policy engine is a consumer of the shared resilience plane
(:mod:`repro_torch.resilience`): an armed
:class:`~repro_torch.resilience.faults.FaultPlan` can drop heartbeats
(``train.heartbeat``) and inflate step times (``train.straggler``)
deterministically, and every RESTART/REDISPATCH decision is recorded as
a :class:`~repro_torch.resilience.ladder.FailureEvent` on
``monitor.events`` — the same taxonomy the codegen ladder and the serving engine use.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..resilience import faults
from ..resilience.ladder import FailureEvent


@dataclass
class FaultConfig:
    dead_after: float = 60.0
    straggler_factor: float = 1.5
    patience: int = 3


@dataclass
class HostState:
    last_beat: float = 0.0
    ewma_step: float = 0.0
    slow_streak: int = 0


class FaultMonitor:
    def __init__(self, hosts: List[str], cfg: FaultConfig = FaultConfig(),
                 clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_beat=clock()) for h in hosts}
        self.events: List[FailureEvent] = []

    def heartbeat(self, host: str) -> None:
        if faults.ACTIVE and faults.fire("train.heartbeat"):
            return  # beat lost in flight
        self.hosts[host].last_beat = self.clock()

    def report_step(self, host: str, seconds: float) -> None:
        if faults.ACTIVE and faults.fire("train.straggler"):
            seconds *= 2.0 * self.cfg.straggler_factor
        st = self.hosts[host]
        st.ewma_step = (0.7 * st.ewma_step + 0.3 * seconds
                        if st.ewma_step else seconds)

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.cfg.dead_after]

    def stragglers(self) -> List[str]:
        med = sorted(st.ewma_step for st in self.hosts.values())[
            len(self.hosts) // 2]
        out = []
        for h, st in self.hosts.items():
            if med > 0 and st.ewma_step > self.cfg.straggler_factor * med:
                st.slow_streak += 1
                if st.slow_streak >= self.cfg.patience:
                    out.append(h)
            else:
                st.slow_streak = 0
        return out

    def decide(self) -> Tuple[str, List[str]]:
        dead = self.dead_hosts()
        if dead:
            for h in dead:
                self.events.append(FailureEvent(
                    site="train.heartbeat", rung="fleet",
                    cause=f"host {h} silent past dead_after", retries=0,
                    outcome="descend"))
            return "RESTART_ELASTIC", dead
        slow = self.stragglers()
        if slow:
            for h in slow:
                self.events.append(FailureEvent(
                    site="train.straggler", rung="fleet",
                    cause=f"host {h} slower than fleet median", retries=0,
                    outcome="retry"))
            return "REDISPATCH", slow
        return "OK", []


def plan_remesh(n_devices: int, model_size: int = 16,
                pod_size: int = 256) -> Tuple[int, ...]:
    """Largest fillable mesh after losing nodes: keep the model axis whole
    (stateful TP/EP shards), shrink data, then drop pods."""
    if n_devices >= 2 * pod_size:
        pods = n_devices // pod_size
        return (pods, pod_size // model_size, model_size)
    data = max(1, n_devices // model_size)
    return (data, model_size)


def remesh(n_devices: int, device_type: str = "cuda", **kw):
    """The ``DeviceMesh`` of :func:`plan_remesh`'s shape over the running
    process group, its axes named as
    :func:`repro_torch.launch.mesh.make_production_mesh` names them
    (``("data", "model")``, or ``("pod", "data", "model")`` across
    pods); ``kw`` goes to :func:`plan_remesh`."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = plan_remesh(n_devices, **kw)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                            "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
