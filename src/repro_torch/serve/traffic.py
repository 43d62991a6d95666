"""Continuous-traffic harness for the serving engine.

The counterpart of the JAX package's ``serve/traffic.py``, numpy on top
of the port's engine.  Drives :class:`~repro_torch.serve.engine.Engine`
under a synthetic open-loop load — Poisson arrivals, ragged prompt/output
lengths, slot churn at wave granularity — and reduces the engine's per-wave
:class:`~repro_torch.serve.engine.WaveStats` into a latency, throughput
and poison report.

The simulation keeps a single **virtual clock**: arrivals are stamped from
an exponential inter-arrival draw, each served wave advances the clock by
its *measured* wall time, and a request's latency is completion minus
arrival on that clock.  This keeps the harness honest (real compute cost,
including the eager launches of ragged shapes) without needing a real
multi-second soak.

Failure semantics ride on the engine's: a torn wave commits nothing and
its survivors are retried solo; ``serve.storm`` (armed
:class:`~repro_torch.resilience.faults.FaultPlan` only) doubles the pending
queue with synthetic clones (negative rids) which are served like real
load but shed from every stat.  Poisoned MoE dispatch requests — capacity
races — are counted exactly (the model threads the poison count out of
the dispatch), never sampled.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..resilience import faults
from ..resilience.ladder import FailureEvent
from .engine import Engine, Request, WaveStats


@dataclass
class TrafficConfig:
    n_requests: int = 32
    rate: float = 50.0                      # mean arrivals / simulated second
    prompt_len: Tuple[int, int] = (4, 12)   # inclusive lo/hi
    max_new: Tuple[int, int] = (2, 8)       # inclusive lo/hi
    seed: int = 0


@dataclass
class TrafficReport:
    p50_ms: float
    p95_ms: float
    tok_s: float                 # committed tokens / simulated second
    poison_rate: float           # poisoned / issued MoE dispatch requests
    moe_poison: int
    moe_requests: int
    n_completed: int
    n_failed: int
    n_truncated: int
    tokens: int
    wall_s: float                # total simulated wall time
    waves: List[WaveStats] = field(default_factory=list)
    latencies_ms: List[float] = field(default_factory=list)


def make_requests(cfg: TrafficConfig, vocab: int
                  ) -> Tuple[List[Request], np.ndarray]:
    """Draw the request trace: ragged prompts/outputs + Poisson arrivals."""
    rng = np.random.default_rng(cfg.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / cfg.rate, cfg.n_requests))
    reqs = []
    for i in range(cfg.n_requests):
        plen = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        mnew = int(rng.integers(cfg.max_new[0], cfg.max_new[1] + 1))
        prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=mnew))
    return reqs, arrivals


def run_traffic(engine: Engine, cfg: TrafficConfig) -> TrafficReport:
    """Serve the whole trace; returns the reduced report.

    Wave formation mirrors ``Engine.run``: up to ``engine.slots`` pending
    requests per wave (slot churn — whoever has arrived rides the next
    wave), retried requests run solo.
    """
    reqs, arrivals = make_requests(cfg, engine.cfg.vocab)
    arrival_at = {r.rid: float(arrivals[i]) for i, r in enumerate(reqs)}

    pending: deque = deque()
    if faults.ACTIVE and faults.fire("serve.storm"):
        # the whole trace storms in as synthetic clones on top of real load
        clones = [Request(rid=-(i + 1), prompt=r.prompt, max_new=r.max_new)
                  for i, r in enumerate(reqs)]
        for c in clones:
            arrival_at[c.rid] = arrival_at[reqs[abs(c.rid) - 1].rid]
        reqs = [x for pair in zip(reqs, clones) for x in pair]
        arrivals = np.repeat(arrivals, 2)
        engine.events.append(FailureEvent(
            site="serve.storm", rung="wave",
            cause=f"traffic storm (+{len(clones)} synthetic requests)",
            retries=0, outcome="shed"))

    results: Dict[int, List[int]] = {}
    finish_at: Dict[int, float] = {}
    waves: List[WaveStats] = []
    clock = 0.0
    nxt = 0  # next arrival index

    while nxt < len(reqs) or pending:
        if not pending:
            clock = max(clock, float(arrivals[nxt]))
        while nxt < len(reqs) and float(arrivals[nxt]) <= clock:
            pending.append(reqs[nxt])
            nxt += 1
        if not pending:
            continue
        if pending[0].retries:
            wave = [pending.popleft()]
        else:
            wave = []
            while (pending and len(wave) < engine.slots
                   and not pending[0].retries):
                wave.append(pending.popleft())
        st = engine.serve_wave(wave, pending, results)
        if st is not None:
            clock += st.wall_s
            waves.append(st)
        for r in wave:
            if r.done and r.rid >= 0 and r.rid not in finish_at:
                finish_at[r.rid] = clock

    real = [r for r in reqs if r.rid >= 0]
    lat_ms = sorted((finish_at[r.rid] - arrival_at[r.rid]) * 1000.0
                    for r in real if not r.failed)
    # goodput counts only real requests' tokens — storm clones are shed;
    # poison/issued stay as measured (they describe the dispatch kernels'
    # behavior over ALL work done, clones included)
    tokens = sum(len(r.out) for r in real)
    poison = sum(w.moe_poison for w in waves)
    issued = sum(w.moe_requests for w in waves)
    return TrafficReport(
        p50_ms=float(np.percentile(lat_ms, 50)) if lat_ms else float("nan"),
        p95_ms=float(np.percentile(lat_ms, 95)) if lat_ms else float("nan"),
        tok_s=tokens / clock if clock > 0 else 0.0,
        poison_rate=poison / issued if issued else 0.0,
        moe_poison=poison, moe_requests=issued,
        n_completed=sum(1 for r in real if r.done and not r.failed),
        n_failed=sum(1 for r in real if r.failed),
        n_truncated=sum(1 for r in real if r.truncated),
        tokens=tokens, wall_s=clock, waves=waves, latencies_ms=lat_ms)
