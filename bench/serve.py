"""Drive the port's serving engine through one measured window.

The entry is the engine's own ``Engine.serve_wave``; the benchmark forms
the waves as ``Engine.run`` does (up to ``slots`` requests, a retried
request alone) from a live queue that holds only the requests whose due
time has passed when it is read.  ``Stamped`` stands in for
``engine.model``: around each ``prefill`` / ``decode_step`` it
synchronises the device, keeps the call's host time, and stamps every
output token of the wave with the moment it first appears in its
``Request.out`` (at each model call, and again when the wave returns).
It also keeps each decode call's input tokens on the host: with the
prompts they are the whole wave, which the reference follows afterwards.

Closed loop: ``clients`` callers, each sending its next request the
moment its last one is answered; no wave starts after the window closes.
Open loop: request ``i`` is due ``offset_s(i)`` after the window opens;
every request due inside the window is served, those still waiting at
the close afterwards (the drain), and its time to first token counts
from its due time.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class ReqRecord:
    """One request as the benchmark saw it."""
    rid: int
    prompt: np.ndarray
    max_new: int
    due: float
    start: Optional[float] = None      # its wave began
    stamps: List[float] = field(default_factory=list)
    wave: Optional[int] = None
    failed: bool = False
    truncated: bool = False
    out: List[int] = field(default_factory=list)


@dataclass
class WaveRecord:
    """One wave: its requests in slot order and the tokens it was fed."""
    rids: List[int]
    start: float
    end: float = 0.0
    prompt_tokens: Optional[np.ndarray] = None   # (B, plen) as sent
    fed: List[np.ndarray] = field(default_factory=list)  # decode inputs
    ok: bool = False
    poison: int = 0          # the engine's poisoned dispatch requests


@dataclass
class Call:
    """One model call: host start and end (synced), rows and columns."""
    kind: str
    t0: float
    t1: float
    rows: int
    cols: int
    wave: int


class Stamped:
    """The engine's model with the benchmark's clock around each call."""

    def __init__(self, model, run: "RunData", sync):
        self.model, self.run, self.sync = model, run, sync
        self.wave: List = []
        self.wave_index = -1

    def stamp(self) -> None:
        now = time.perf_counter()
        for r in self.wave:
            rec = self.run.requests.get(r.rid)
            if rec is None:
                continue
            while len(rec.stamps) < len(r.out):
                rec.stamps.append(now)

    def _call(self, kind, fn, tokens, *args, **kw):
        self.stamp()
        w = self.run.waves[self.wave_index] if self.wave_index >= 0 \
            else None
        if w is not None:
            host = tokens.cpu().numpy()
            if kind == "prefill":
                w.prompt_tokens = host
            else:
                w.fed.append(host[:, 0].copy())
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"serve.{fn.__name__}"):
            out = fn(*args, **kw)
            self.sync()
        t1 = time.perf_counter()
        if self.wave_index >= 0:
            self.run.calls.append(Call(kind, t0, t1, tokens.shape[0],
                                       tokens.shape[1], self.wave_index))
        return out

    def prefill(self, params, tokens, *args, **kw):
        return self._call("prefill", self.model.prefill, tokens, params,
                          tokens, *args, **kw)

    def decode_step(self, params, cache, tokens, *args, **kw):
        return self._call("decode", self.model.decode_step, tokens, params,
                          cache, tokens, *args, **kw)


@dataclass
class RunData:
    """What one window produced, for the metric readers and the judge."""
    mix: Dict
    port: Dict
    seconds: float
    t0: float = 0.0
    t_end: float = 0.0
    requests: Dict[int, ReqRecord] = field(default_factory=dict)
    waves: List[WaveRecord] = field(default_factory=list)
    calls: List[Call] = field(default_factory=list)
    trace: Optional[object] = None
    probes: Dict = field(default_factory=dict)
    late_s: float = 0.0

    def due_in_window(self) -> List[ReqRecord]:
        return [r for r in self.requests.values() if r.due < self.t_end]

    def calls_in_window(self, kind: str) -> List[Call]:
        return [c for c in self.calls if c.kind == kind
                and c.t0 >= self.t0 and c.t1 <= self.t_end]


def warm(engine, traffic, slots: int, sync) -> None:
    """One wave at the cell's slots and longest prompt, three tokens each,
    so that every kernel is built and loaded and the allocator holds the
    window's largest shapes before the clock starts."""
    from repro_torch.serve.engine import Request
    plen = traffic.longest_prompt()
    rng = np.random.default_rng(0)
    wave = [Request(rid=-1 - i, prompt=rng.integers(
        1, traffic.vocab, plen).astype(np.int32), max_new=3)
        for i in range(slots)]
    engine.serve_wave(wave, deque(), {})
    sync()
    if engine.events:
        raise RuntimeError(f"warm wave failed: {engine.events}")


def serve_window(engine, traffic, run: RunData, sync,
                 drain: bool = True) -> None:
    """Serve the mix for ``run.seconds`` and drain what was due (unless
    ``drain`` is False: a rate sweep reads the backlog instead)."""
    from repro_torch.serve.engine import Request
    mix = traffic.mix
    slots = mix["slots"]
    stamped = Stamped(engine.model, run, sync)
    engine.model = stamped
    ready: deque = deque()
    results: Dict[int, List[int]] = {}
    nxt = 0
    closed = mix["loop"] == "closed"

    def issue(due: float) -> None:
        nonlocal nxt
        d = traffic.request(nxt)
        r = Request(rid=nxt, prompt=d.prompt, max_new=d.max_new)
        run.requests[nxt] = ReqRecord(nxt, d.prompt, d.max_new, due)
        nxt += 1
        ready.append(r)

    with torch.profiler.record_function("bench.window"):
        run.t0 = time.perf_counter()
    run.t_end = run.t0 + run.seconds
    if closed:
        for _ in range(mix["clients"]):
            issue(run.t0)
    while True:
        now = time.perf_counter()
        if not closed:
            # release every request due by now; schedule ahead lazily
            while traffic.offset_s(nxt) < min(now - run.t0, run.seconds):
                issue(run.t0 + traffic.offset_s(nxt))
        if not ready:
            if closed or traffic.offset_s(nxt) >= run.seconds:
                break
            # idle until the next arrival; how late the wake-up comes is
            # how late the generator ran
            target = run.t0 + traffic.offset_s(nxt)
            with torch.profiler.record_function("bench.idle"):
                time.sleep(max(0.0, target - time.perf_counter()))
            run.late_s = max(run.late_s, time.perf_counter() - target)
            continue
        if not closed and not drain and now >= run.t_end:
            break
        if closed and now >= run.t_end:
            # the window closed before these were sent: never attempted
            for r in ready:
                del run.requests[r.rid]
            break
        if ready[0].retries:
            wave = [ready.popleft()]
        else:
            wave = []
            while ready and len(wave) < slots and not ready[0].retries:
                wave.append(ready.popleft())
        start = time.perf_counter()
        idx = len(run.waves)
        run.waves.append(WaveRecord([r.rid for r in wave], start))
        for r in wave:
            rec = run.requests[r.rid]
            rec.start = start if rec.start is None else rec.start
            rec.wave = idx
        stamped.wave, stamped.wave_index = wave, idx
        with torch.profiler.record_function("bench.wave"):
            stats = engine.serve_wave(wave, ready, results)
        stamped.stamp()
        run.waves[idx].end = time.perf_counter()
        run.waves[idx].ok = stats is not None
        run.waves[idx].poison = stats.moe_poison if stats else 0
        for r in wave:
            rec = run.requests[r.rid]
            rec.failed, rec.truncated = r.failed, r.truncated
            rec.out = list(r.out)
            if r.done and closed and run.waves[idx].end < run.t_end:
                issue(run.waves[idx].end)
    stamped.wave, stamped.wave_index = [], -1
    engine.model = stamped.model


def device_sync(device) -> callable:
    """A function that waits for ``device``'s queued work."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
