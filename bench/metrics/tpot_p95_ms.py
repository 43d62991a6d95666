"""tpot_p95_ms: time per output token, the 95th percentile over the
requests due in the window of a request's mean gap between consecutive
output tokens (its span from first to last token over the gaps in it,
host clock).  A request's span holds 15 or more decode steps, a quarter
of a second or more, where one gap is a single host-clock reading of a
step."""
import numpy as np


def read(run):
    per = [(r.stamps[-1] - r.stamps[0]) / (len(r.stamps) - 1)
           for r in run.due_in_window() if len(r.stamps) >= 2]
    if not per:
        return None
    return float(np.percentile(per, 95)) * 1e3
