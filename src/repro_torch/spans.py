"""Spans and counters of the serving path, kept in the program's memory.

A span is a named interval of the host clock (``time.perf_counter_ns``)
with its parent span, the engine's wave and decode step it fell in, and
counters as attributes.  The serving path opens them at its layer
boundaries:

* ``engine.wave``: ``Engine.serve_wave``, the whole wave (``wave``,
  ``batch``, ``tokens``);
* ``engine.commit``: each decode step's host work in
  ``Engine._run_wave``: the argmax readback, token appends, truncation
  checks (``rows``, ``live_rows``);
* ``model.prefill``, ``model.decode_step``: ``Model.prefill`` /
  ``Model.decode_step``, the host time to issue the call;
* ``model.attn``: ``Model._sublayer`` of an attention sublayer;
  ``model.head``: ``Model._head``;
* ``attn.qkv``, ``attn.cache``, ``attn.expand``, ``attn.core``,
  ``attn.out``: ``layers.gqa_attention`` on a plain KV cache: the
  projections and RoPE, the cache write, the GQA expansion, scores,
  softmax and values, the output projection;
* ``moe.layer``: ``moe.moe_spec`` (``rows``, ``requests``, ``poisoned``,
  ``experts_touched``, ``experts_read``);
* ``moe.route``, ``moe.dispatch``, ``moe.ffn``, ``moe.combine``,
  ``moe.shared``: ``moe._moe_spec_flat``: router and top-k,
  ``spec_dispatch_indices``, the buffer fill and expert FFN, the gather
  and gates, the shared expert.

Every span but the engine's carries **device marks** inside an engine
wave on a CUDA device: a CUDA event recorded where the span opens and
where it closes.  They are resolved against an anchor event recorded
right after a synchronise when the wave began, so each marked span also
has a device interval (``d0``, ``d1``) on the same host clock.  Counters
that live on the device (a call's poisoned requests, the experts it
touched) stay there and are read in one transfer.  Switched on, both are
resolved when the wave ends, after the engine's own synchronise; under
the profiler (the default switch) they wait until they are read
(:func:`records`, :func:`summary`), because each event's reading costs
tens of microseconds of host time under the profiler's tracing and would
show as idle time of the traced window.

The spans are not ``torch.profiler`` ranges: a range that launches
kernels leaves a device-side span in the trace, which a reduction of the
trace takes for device work.  They live here instead, and
:func:`to_profiler_ns` puts any of them on the profiler's clock (Unix
time in ns) through one pair of clock readings taken when the recorder
turns on.

The switch is :func:`enable`: ``True`` records, ``False`` does not, and
``None`` (the default) records exactly the waves that begin while a
``torch.profiler`` session is active.  Each span site tests the module's
:data:`ON` once and, while it is False, allocates nothing, records no
event and runs nothing on the device::

    sp = spans.ON and spans.open("model.head", mark=True)
    ...
    if sp:
        spans.close(sp)

Spans are kept in a bounded buffer (:data:`CAPACITY`; the oldest drop
first, counted by :func:`dropped`) and read by :func:`records` and
:func:`summary`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import torch

#: tested at every span site; True while the recorder records
ON = False

#: spans kept; a decode step of a one-layer model opens 15
CAPACITY = 1 << 17

#: anchor readings taken when a wave begins on a CUDA device; the one
#: whose host readings lie closest together is kept
ANCHOR_TRIES = 3


class Span:
    """One span: host times ``t0``, ``t1`` and device times ``d0``,
    ``d1`` (None where unmarked or not yet resolved) in
    ``perf_counter_ns``; ``parent`` is the enclosing span's ``id``."""
    __slots__ = ("id", "name", "parent", "wave", "step", "t0", "t1", "d0",
                 "d1", "attrs", "ev0", "ev1")

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"wave={self.wave}, step={self.step}, t0={self.t0}, "
                f"t1={self.t1}, d0={self.d0}, d1={self.d1}, {self.attrs})")


class _Recorder:
    def __init__(self, capacity: int = CAPACITY):
        self.switch: Optional[bool] = None
        self.buf: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.next_id = 0
        self.stack: List[Span] = []
        self.wave = -1
        self.step = -1
        self.clock: Optional[tuple] = None   # (perf_counter_ns, time_ns)
        self.stream = None                   # a CUDA wave's stream
        self.anchor = None                   # (event, host ns, error ns)
        self.marked: List[tuple] = []        # (anchor, [closed spans])
        self.pending = 0                     # spans in ``marked``
        self.counted: List[Span] = []
        self.pool: List = []                 # free CUDA events

    def event(self):
        return self.pool.pop() if self.pool else \
            torch.cuda.Event(enable_timing=True)


_REC = _Recorder()


def _clock_pair() -> tuple:
    a = time.perf_counter_ns()
    wall = time.time_ns()
    return ((a + time.perf_counter_ns()) // 2, wall)


def _turn(on: bool) -> None:
    global ON
    if on and not ON:
        _REC.clock = _clock_pair()
    ON = on


def enable(on: Optional[bool] = None) -> None:
    """``True``: record; ``False``: do not; ``None`` (the default):
    record the waves that begin while a ``torch.profiler`` session is
    active (checked when each wave begins)."""
    _REC.switch = on
    _turn(bool(on))


def reset() -> None:
    """Forget every span and pending read (the switch stays)."""
    rec = _REC
    rec.buf.clear()
    rec.dropped = 0
    rec.stack.clear()
    rec.marked.clear()
    rec.counted.clear()
    rec.pending = 0
    rec.anchor = rec.stream = None
    rec.wave = rec.step = -1


def open(name: str, mark: bool = False, **attrs) -> Span:  # noqa: A001
    """Open a span inside the innermost open one; ``mark``: record a
    device mark where it opens and where it closes (inside a wave on a
    CUDA device)."""
    return _open(name, attrs, time.perf_counter_ns(),
                 _mark() if mark else None)


def close(s: Span, **attrs) -> None:
    """Close ``s`` (and any span left open inside it)."""
    _close(s, None, None)
    if attrs:
        put(s, **attrs)


def swap(s: Span, name: str, **attrs) -> Span:
    """Close ``s`` and open its next sibling ``name`` at the same host
    reading and, where ``s`` is marked, the same device mark."""
    ev = _mark() if s.ev0 is not None else None
    t = time.perf_counter_ns()
    _close(s, t, ev)
    return _open(name, attrs, t, ev)


def put(s: Span, **attrs) -> None:
    """Set counters on ``s``; a tensor's value is read when the wave
    ends (or by :func:`records`), in one transfer with the others."""
    s.attrs.update(attrs)
    if any(isinstance(v, torch.Tensor) for v in attrs.values()):
        _REC.counted.append(s)
        if len(_REC.counted) >= CAPACITY:
            resolve()


def set_step(step: int) -> None:
    """The engine's decode step that spans opened from here fall in."""
    _REC.step = step


def wave_begin(device, wave: int, **attrs) -> Optional[Span]:
    """Where wave ``wave`` begins: check the switch (under ``None``,
    whether a profiler session is active) and, while on, open
    ``engine.wave`` and, on a CUDA device, take the anchor of the wave's
    device marks.  Returns the span, or None while off."""
    rec = _REC
    if rec.switch is None:
        _turn(_profiling())
    if not ON:
        return None
    rec.wave, rec.step = wave, -1
    attrs["wave"] = wave
    if device.type == "cuda":
        rec.stream = torch.cuda.current_stream(device)
        rec.anchor = _anchor(device)
        rec.marked.append((rec.anchor, []))
    return _open("engine.wave", attrs, time.perf_counter_ns(), None)


def wave_end(s: Span, t1: int, **attrs) -> None:
    """Close the wave's span at the host reading ``t1``; switched on,
    resolve its device marks and counters (under ``None`` they wait to be
    read, and the recorder waits for the next wave's check)."""
    _close(s, t1, None)
    put(s, **attrs)
    _REC.anchor = _REC.stream = None
    if _REC.switch:
        resolve()
    if _REC.switch is None:
        _turn(False)


def resolve() -> None:
    """Give every closed marked span its device interval and every
    counter its value (one synchronise and one transfer)."""
    rec = _REC
    if rec.pending:
        last = [b for _, b in rec.marked if b][-1]
        last[-1].ev1.synchronize()
        for anchor, batch in rec.marked:
            ev_a, host, _ = anchor
            times: Dict[int, int] = {}
            for s in batch:
                for ev in (s.ev0, s.ev1):
                    if id(ev) not in times:
                        times[id(ev)] = host + round(
                            ev_a.elapsed_time(ev) * 1e6)
                        rec.pool.append(ev)
                s.d0, s.d1 = times[id(s.ev0)], times[id(s.ev1)]
                s.ev0 = s.ev1 = None
            if anchor is not rec.anchor:
                rec.pool.append(ev_a)
        rec.marked = [(rec.anchor, [])] if rec.anchor is not None else []
        rec.pending = 0
    if rec.counted:
        keys = [(s, k) for s in rec.counted for k, v in s.attrs.items()
                if isinstance(v, torch.Tensor)]
        vals = torch.stack([s.attrs[k].reshape(()).to(torch.int64)
                            for s, k in keys]).tolist()
        for (s, k), v in zip(keys, vals):
            s.attrs[k] = v
        rec.counted.clear()


def records() -> List[Span]:
    """The spans kept, in the order they opened (device marks and
    counters resolved)."""
    resolve()
    return list(_REC.buf)


def dropped() -> int:
    """Spans dropped from the full buffer, oldest first."""
    return _REC.dropped


def summary() -> Dict[str, Dict[str, float]]:
    """By span name: ``count``, host total ``host_s``, host self time
    ``self_s`` (the duration less what its child spans cover) and device
    total ``device_s`` (marked spans), over the closed spans kept."""
    recs = [s for s in records() if s.t1 is not None]
    covered: Dict[int, int] = {}
    for s in recs:
        if s.parent is not None:
            covered[s.parent] = covered.get(s.parent, 0) + s.t1 - s.t0
    out: Dict[str, Dict[str, float]] = {}
    for s in recs:
        row = out.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "device_s": 0.0})
        row["count"] += 1
        row["host_s"] += (s.t1 - s.t0) / 1e9
        row["self_s"] += (s.t1 - s.t0 - covered.get(s.id, 0)) / 1e9
        if s.d1 is not None:
            row["device_s"] += (s.d1 - s.d0) / 1e9
    return out


def to_profiler_ns(t: int) -> int:
    """The ``perf_counter_ns`` reading ``t`` on ``torch.profiler``'s
    host clock (Unix time in ns), through the pair of readings taken
    when the recorder last turned on."""
    if _REC.clock is None:
        _REC.clock = _clock_pair()
    pc, wall = _REC.clock
    return t - pc + wall


# ---------------------------------------------------------------------------
# internals
# ---------------------------------------------------------------------------


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _mark():
    """A CUDA event recorded on the wave's stream, or None outside a
    wave on a CUDA device."""
    rec = _REC
    if rec.anchor is None:
        return None
    ev = rec.event()
    ev.record(rec.stream)
    return ev


def _open(name: str, attrs: Dict, t0: int, ev) -> Span:
    rec = _REC
    s = Span()
    s.id = rec.next_id
    rec.next_id += 1
    s.name = name
    s.parent = rec.stack[-1].id if rec.stack else None
    s.wave, s.step = rec.wave, rec.step
    s.t0, s.t1, s.d0, s.d1 = t0, None, None, None
    s.attrs = attrs
    s.ev0, s.ev1 = ev, None
    if len(rec.buf) == rec.buf.maxlen:
        rec.dropped += 1
    rec.buf.append(s)
    rec.stack.append(s)
    return s


def _close(s: Span, t1: Optional[int], ev) -> None:
    """Close ``s`` at ``t1`` (read after its mark when None) with its
    closing mark ``ev`` (recorded here when None)."""
    rec = _REC
    if s.ev0 is not None:
        s.ev1 = ev if ev is not None else _mark()
        if s.ev1 is not None:
            rec.marked[-1][1].append(s)
            rec.pending += 1
            if rec.pending >= CAPACITY:
                resolve()
    s.t1 = time.perf_counter_ns() if t1 is None else t1
    while rec.stack:
        if rec.stack.pop() is s:
            break


def _anchor(device):
    """(event, host ns, error ns): an event recorded on the idle device
    and the host reading that stands for it, the middle of the readings
    before its record and after its completion; half their distance is
    the error.  The closest of :data:`ANCHOR_TRIES` is kept."""
    rec = _REC
    torch.cuda.synchronize(device)
    best = None
    for _ in range(ANCHOR_TRIES):
        ev = rec.event()
        a = time.perf_counter_ns()
        ev.record(rec.stream)
        ev.synchronize()
        b = time.perf_counter_ns()
        if best is None or (b - a) // 2 < best[2]:
            if best is not None:
                rec.pool.append(best[0])
            best = (ev, (a + b) // 2, (b - a) // 2)
        else:
            rec.pool.append(ev)
    return best
