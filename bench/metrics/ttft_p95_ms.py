"""ttft_p95_ms: the 95th percentile, over every request due in the
window (those still waiting at the close are drained and counted), of
the time from its due time to its first output token; a request that
failed or served nothing counts as missing every limit."""
import math

import numpy as np


def read(run):
    waits = [r.stamps[0] - r.due if r.stamps and not r.failed else math.inf
             for r in run.due_in_window()]
    if not waits:
        return None
    value = float(np.percentile(waits, 95, method="higher"))
    return value * 1e3 if math.isfinite(value) else None
