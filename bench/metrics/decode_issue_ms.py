"""decode_issue_ms: the port's host time to issue a decode call, the
mean over the window's ``model.decode_step`` spans (``Model.decode_step``,
inside the benchmark's synchronised clock; what ``decode_step_ms`` holds
beyond it is the device's tail)."""
from bench.program_spans import named, window_spans


def read(run):
    steps = named(window_spans(run), "model.decode_step")
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) / 1e6
