"""Batched serving engine: continuous-batching-lite over prefill/decode.

The counterpart of the JAX package's ``serve/engine.py``.  Requests join
a fixed-slot batch and are served in waves; greedy sampling.  Left-pad
slots are *poisoned*, not fed as token 0: per-row ``pad_lens`` masks them
out of every attention read and re-bases RoPE, so a batched request
emits what its solo run emits (in the ssm and hybrid families the pads
still flow into the SSM states, as in the reference).  A request that runs out of KV cache
(``max_len``) with output budget remaining is marked ``truncated=True``
and recorded as a ``serve.truncate``
:class:`~repro_torch.resilience.ladder.FailureEvent`, never a silent cut.
Every successful wave appends a :class:`WaveStats` (wall time, committed
tokens, MoE poison counts) to ``Engine.wave_stats``, the feed of
:mod:`repro_torch.serve.traffic`.  The poison count stays on the device
through the wave and is read once, after the wave's final synchronise.
While :mod:`repro_torch.spans` records, a wave is an ``engine.wave`` span
(on the same pair of clock readings as ``WaveStats.wall_s``) and each
decode step's host work an ``engine.commit`` span.

Failure semantics: a request that raises during a wave does not lose the
whole wave.  The wave's partial tokens are discarded (a torn wave never
commits), the poisoned request (named by the fault's ``rid`` when it
carries one) is marked ``failed``, and the survivors are re-queued for a
bounded number of solo retries (``wave_retries``).  Every retry and
failure is recorded on ``Engine.events``.

Fault sites (armed :class:`~repro_torch.resilience.faults.FaultPlan`
only): ``serve.slot`` (one slot dies at wave start, poisoning its
request), ``serve.decode`` (a decode step times out, killing the wave with
no culprit), ``serve.storm`` (the queue doubles with synthetic clones,
served and then shed from the results).

The engine runs on ``device``: ``cuda`` unless the caller names another,
raising when there is no card, never falling back to the CPU.  Decode
runs eagerly, one ``decode_step`` per committed token.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import spans
from ..configs.base import ArchConfig
from ..kernels.dispatch import resolve_device
from ..models.model import build_model, group_count, group_pattern
from ..resilience import faults
from ..resilience.faults import InjectedFault
from ..resilience.ladder import FailureEvent


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    retries: int = 0
    failed: bool = False
    error: Optional[str] = None
    truncated: bool = False  # hit max_len with output budget remaining


@dataclass
class WaveStats:
    """Structured per-wave serving stats."""
    batch: int           # requests in the wave
    wall_s: float        # measured wall time (prefill + decode, synced)
    tokens: int          # committed output tokens
    moe_poison: int      # poisoned MoE dispatch requests (capacity races)
    moe_requests: int    # total MoE dispatch requests issued
    truncated: int       # requests cut off at max_len this wave


class Engine:
    def __init__(self, cfg: ArchConfig, params=None, *, slots: int = 4,
                 max_len: int = 128, dispatch: str = "spec",
                 wave_retries: int = 1, device=None):
        self.cfg = cfg
        self.device = resolve_device(device, "serve")
        self.model = build_model(cfg, dispatch=dispatch)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = self.model.init(gen, self.device)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.wave_retries = wave_retries
        self.events: List[FailureEvent] = []
        self.wave_stats: List[WaveStats] = []
        self.waves_begun = 0
        # MoE dispatch requests issued per token position (for poison rates)
        pattern = group_pattern(cfg)
        self._moe_per_tok = (pattern.count("moe") * group_count(cfg)
                             * (cfg.top_k or 0))

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve all requests; batched prefill per wave, partial results
        on failure (see the module docstring)."""
        queue: deque = deque(requests)
        if faults.ACTIVE and faults.fire("serve.storm"):
            # request storm: synthetic clones (negative rids) double the
            # queue; they are served like real load but shed from results
            clones = [Request(rid=-(i + 1), prompt=r.prompt,
                              max_new=r.max_new)
                      for i, r in enumerate(requests)]
            queue.extend(clones)
            self.events.append(FailureEvent(
                site="serve.storm", rung="wave",
                cause=f"queue doubled (+{len(clones)} synthetic requests)",
                retries=0, outcome="shed"))
        results: Dict[int, List[int]] = {}
        while queue:
            # retried requests run solo: one poisoned request must not
            # take fresh work down with it twice
            if queue[0].retries:
                wave = [queue.popleft()]
            else:
                wave = []
                while (queue and len(wave) < self.slots
                       and not queue[0].retries):
                    wave.append(queue.popleft())
            self.serve_wave(wave, queue, results)
        return results

    def serve_wave(self, wave: List[Request], queue: deque,
                   results: Dict[int, List[int]]) -> Optional[WaveStats]:
        """Run one wave with torn-wave containment.  On success the wave's
        tokens are committed into ``results`` and its :class:`WaveStats`
        is returned (and appended to ``self.wave_stats``).  On a fault the
        partial tokens are discarded, the culprit (or the requests out of
        retries) fail, the survivors go back onto ``queue``, and None is
        returned: a torn wave never commits and never produces stats."""
        ws = spans.wave_begin(self.device, wave=self.waves_begun,
                              batch=len(wave))
        self.waves_begun += 1
        try:
            stats = self._run_wave(wave, ws)
        except Exception as e:  # noqa: BLE001 — degrade, don't crash
            if ws:
                spans.wave_end(ws, time.perf_counter_ns(), failed=1)
            rid = getattr(e, "rid", None)
            site = getattr(e, "site", "")
            for r in wave:
                r.out.clear()  # never commit a torn wave's tokens
                poisoned = rid is not None and r.rid == rid
                if poisoned or r.retries >= self.wave_retries:
                    r.failed = True
                    r.error = str(e)
                    r.done = True
                    self.events.append(FailureEvent(
                        site=site, rung="solo" if r.retries else "wave",
                        cause=str(e), retries=r.retries,
                        outcome="failed"))
                    if r.rid >= 0:
                        results[r.rid] = r.out
                elif r.rid < 0:
                    pass  # synthetic storm clone: shed, don't retry
                else:
                    self.events.append(FailureEvent(
                        site=site, rung="wave", cause=str(e),
                        retries=r.retries, outcome="retry"))
                    r.retries += 1
                    queue.appendleft(r)
            return None
        self.wave_stats.append(stats)
        for r in wave:
            if r.rid >= 0:
                results[r.rid] = r.out
        return stats

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_wave(self, wave: List[Request], ws) -> WaveStats:
        """One wave; ``ws`` is its ``engine.wave`` span, or None while
        the recorder is off."""
        if faults.ACTIVE:
            for r in wave:
                if faults.fire("serve.slot"):
                    raise InjectedFault(
                        "serve.slot", f"slot died serving request {r.rid}",
                        rid=r.rid)
        b = len(wave)
        t0 = ws.t0 if ws else time.perf_counter_ns()
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int32)
        pads = np.zeros((b,), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
            pads[i] = plen - len(r.prompt)
        # pad slots are poisoned requests, not token 0: pad_lens masks them
        # out of attention and re-bases RoPE, so a batched request decodes
        # exactly what its solo run would
        pad_lens = torch.from_numpy(pads).to(self.device)
        logits, cache, pstats = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            max_len=self.max_len, pad_lens=pad_lens, return_stats=True)
        # summed on the device, read once after the wave's synchronise
        poison = pstats["moe_poison"]
        moe_reqs = b * plen * self._moe_per_tok
        pos = plen
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        max_new = max(r.max_new for r in wave)
        tokens = 0
        for step in range(max_new):
            faults.inject("serve.decode")
            cs = None
            if ws:
                spans.set_step(step)
                cs = spans.open("engine.commit")
            host = cur[:, 0].tolist()
            for i, r in enumerate(wave):
                if step < r.max_new:
                    r.out.append(int(host[i]))
                    tokens += 1
            if pos + 1 >= self.max_len:
                if step + 1 < max_new:
                    # out of cache, output budget remaining: an explicit
                    # degradation event, never a silent cut
                    for r in wave:
                        if step + 1 < r.max_new:
                            r.truncated = True
                            self.events.append(FailureEvent(
                                site="serve.truncate", rung="request",
                                cause=(f"request {r.rid} hit max_len="
                                       f"{self.max_len} with "
                                       f"{r.max_new - step - 1} tokens "
                                       "unserved"),
                                retries=r.retries, outcome="truncated"))
                if cs:
                    spans.close(cs)
                break
            if cs:
                # the rows this step computes, and those whose request
                # still needs the token it computes
                spans.close(cs, rows=b, live_rows=sum(
                    step + 1 < r.max_new for r in wave))
            logits, cache, dstats = self.model.decode_step(
                self.params, cache, cur, pos, pad_lens=pad_lens,
                return_stats=True)
            poison = poison + dstats["moe_poison"]
            moe_reqs += b * self._moe_per_tok
            cur = logits.argmax(-1)[:, None].to(torch.int32)
            pos += 1
        self._sync()
        poison = int(poison)
        t1 = time.perf_counter_ns()
        if ws:
            spans.wave_end(ws, t1, tokens=tokens)
        for r in wave:
            r.done = True
        return WaveStats(batch=b, wall_s=(t1 - t0) / 1e9, tokens=tokens,
                         moe_poison=poison, moe_requests=moe_reqs,
                         truncated=sum(r.truncated for r in wave))
