"""The port's own spans (``repro_torch.spans``) inside a run's window,
for the metric readers.

The port records them in its memory while a ``torch.profiler`` session
is active, so the traced run has them with no range of the benchmark's.
A port without the recorder, or a run that recorded nothing, reads
None: a reader then reports nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def window_spans(run) -> Optional[List]:
    """The closed spans that lie wholly inside ``[run.t0, run.t_end]``
    (host clock), in the order they opened, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    lo, hi = run.t0 * 1e9, run.t_end * 1e9
    got = [s for s in spans.records()
           if s.t1 is not None and lo <= s.t0 and s.t1 <= hi]
    return got or None


def named(spans: Optional[List], name: str) -> List:
    """The spans called ``name``, in order."""
    return [s for s in spans or () if s.name == name]


def in_decode(spans: Optional[List], name: str) -> Dict[int, List]:
    """The spans ``name`` directly inside each ``model.decode_step``
    span, by the step span's id (a step with none maps to [])."""
    steps = {s.id: [] for s in named(spans, "model.decode_step")}
    for s in named(spans, name):
        if s.parent in steps:
            steps[s.parent].append(s)
    return steps


def device_ms_per_step(run, name: str) -> Optional[float]:
    """The device time of the ``name`` spans inside decode calls, over
    the decode calls whose spans all carry device marks, in ms."""
    steps = in_decode(window_spans(run), name)
    marked = [v for v in steps.values()
              if v and all(s.d1 is not None for s in v)]
    if not marked:
        return None
    return sum(s.d1 - s.d0 for v in marked for s in v) / len(marked) / 1e6
