"""The traced run: the benchmark's ranges and the profiler's reduction.

With ``--trace 1`` the window runs under ``torch.profiler`` (CPU and
CUDA activity), and the benchmark wraps, from its own files, the calls
into the layers it reads:

* ``bench.moe`` around ``repro_torch.models.moe.moe_spec``, preceded by
  ``bench.route``: the benchmark's own plain top-k over the layer's input
  and router, which gives the set of experts the call's tokens touch
  (the chosen experts are kept on the device and counted after the
  window).  Kernels inside
  ``bench.route`` count neither for the layer nor for the device's busy
  time, and the idle time the range makes (its kernels, and gaps while
  the host is inside it) is kept apart as ``own_s``.
* ``serve.prefill`` / ``serve.decode_step`` around the model calls,
  ``bench.wave`` around a wave and ``bench.idle`` around the open loop's
  wait for the next arrival; a zero-length ``bench.window`` marks the
  window's opening, and the window is ``--seconds`` long from there.

The reduction works on plain ``(name, start_ns, end_ns)`` tuples: the
device's work (kernels, copies, sets), the device-side spans of the
ranges (where the work launched inside them ran) and the host ranges.
Busy time is the union of the work's intervals inside the window; a
range's device time is the union of the work whose middle lies in one
of the range's device spans.
"""
from __future__ import annotations

import bisect
import contextlib
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

RANGES = ("bench.window", "bench.wave", "bench.idle", "bench.route",
          "bench.moe", "serve.prefill", "serve.decode_step")
#: host ranges that name what the host was doing during an idle gap,
#: innermost first
HOST_LABELS = ("bench.route", "serve.prefill", "serve.decode_step",
               "bench.wave", "bench.idle")

Span = Tuple[int, int]


@dataclass
class TraceData:
    """The reduced trace of one window."""
    window_s: float
    busy_s: float
    range_busy_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    events: int = 0
    #: the window's idle time the benchmark's own ``bench.route`` made:
    #: its kernels' time, and gaps while the host was inside the range
    own_s: float = 0.0


@contextlib.contextmanager
def layer_ranges(probes: Dict):
    """Wrap the MoE layer in the benchmark's ranges while the block runs,
    recording each call's time, rows and chosen experts in
    ``probes["moe"]``."""
    from repro_torch.models import moe
    probes.setdefault("moe", [])
    saved = moe.moe_spec

    def moe_spec(params, x, *, n_experts, top_k, **kw):
        with torch.profiler.record_function("bench.route"):
            # softmax keeps the order: the top-k of the logits
            chosen = torch.topk(x @ params["router"], top_k, dim=-1).indices
        probes["moe"].append((time.perf_counter(), x.shape[0], chosen))
        with torch.profiler.record_function("bench.moe"):
            return saved(params, x, n_experts=n_experts, top_k=top_k, **kw)

    moe.moe_spec = moe_spec
    try:
        yield
    finally:
        moe.moe_spec = saved


def sm_clock_hz():
    """The card's maximum SM clock as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def profiler():
    """The profiler of a traced run."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=act)


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def events_of(prof) -> Tuple[List, List, List]:
    """(host ranges, device spans of ranges, device work) of a finished
    profile, as (name, start_ns, end_ns) tuples."""
    from torch.autograd import DeviceType
    host, spans, work = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + int(ev.duration_ns()) if hasattr(ev, "duration_ns") \
            else _ns(ev, "end")
        if ev.device_type() == DeviceType.CPU:
            if name in RANGES:
                host.append((name, start, end))
        elif name in RANGES:
            spans.append((name, start, end))
        else:
            work.append((name, start, end))
    return host, spans, work


def _union(intervals: Sequence[Span]) -> List[Span]:
    out: List[Span] = []
    for b, e in sorted(intervals):
        if out and b <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((b, e))
    return out


def _total(intervals: Sequence[Span]) -> int:
    return sum(e - b for b, e in intervals)


def _overlaps(a: Sequence[Span], b: Sequence[Span]) -> List[int]:
    """For each interval of ``a``, the length it shares with ``b``; both
    sorted and disjoint.  One pass over the two lists."""
    out, j = [], 0
    for b0, e0 in a:
        while j < len(b) and b[j][1] <= b0:
            j += 1
        n, k = 0, j
        while k < len(b) and b[k][0] < e0:
            n += min(e0, b[k][1]) - max(b0, b[k][0])
            k += 1
        out.append(n)
    return out


def _inside(spans: Sequence[Span]):
    """A test of whether a point lies in one of ``spans`` (unioned)."""
    spans = _union(spans)
    starts = [b for b, _ in spans]

    def test(t: float) -> bool:
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and t < spans[j][1]
    return test


def reduce(host, spans, work, seconds: float,
           top: int = 10) -> Optional[TraceData]:
    """Reduce one window's events; None when the window's mark is
    absent."""
    marks = [b for n, b, _ in host if n == "bench.window"]
    if not marks:
        return None
    w0 = marks[0]
    w1 = w0 + int(seconds * 1e9)
    by_span: Dict[str, List[Span]] = {}
    for n, b, e in spans:
        by_span.setdefault(n, []).append((b, e))
    in_route = _inside(by_span.get("bench.route", []))
    clipped, route = [], []
    for n, b, e in work:
        b, e = max(b, w0), min(e, w1)
        if e > b:
            (route if in_route((b + e) / 2) else clipped).append((n, b, e))
    busy = _union([(b, e) for _, b, e in clipped])
    route = _union([(b, e) for _, b, e in route])
    in_moe = _inside(by_span.get("bench.moe", []))
    range_busy = {"bench.moe": _total(_union(
        [(b, e) for _, b, e in clipped if in_moe((b + e) / 2)])) / 1e9}
    by_name: Dict[str, int] = {}
    for n, b, e in clipped:
        by_name[n] = by_name.get(n, 0) + (e - b)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps, labelled by the innermost host range around their middle
    tests = {n: _inside([(b, e) for m, b, e in host if m == n])
             for n in HOST_LABELS}
    gaps: Dict[str, int] = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    holes = [(e0, b1) for (_, e0), (b1, _) in zip(edges, edges[1:])
            if b1 > e0]
    own = 0
    for (e0, b1), shared in zip(holes, _overlaps(holes, route)):
        mid = (e0 + b1) / 2
        label = next((n for n in HOST_LABELS if tests[n](mid)),
                     "harness (between waves)")
        own += (b1 - e0) if label == "bench.route" else shared
        if label == "bench.wave":
            label = "engine (between model calls)"
        gaps[label] = gaps.get(label, 0) + (b1 - e0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceData(
        window_s=(w1 - w0) / 1e9, busy_s=_total(busy) / 1e9,
        range_busy_s=range_busy,
        device_ops=[[n[:120], v / 1e9] for n, v in ops],
        idle_gaps=[[n, v / 1e9] for n, v in idle],
        events=len(host) + len(spans) + len(work), own_s=own / 1e9)
