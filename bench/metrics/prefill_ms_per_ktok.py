"""prefill_ms_per_ktok: synced host time of the prefill calls inside the
window per thousand real prompt tokens (pads not counted;
Model.prefill)."""


def read(run):
    calls = run.calls_in_window("prefill")
    tokens = sum(len(run.requests[rid].prompt)
                 for c in calls for rid in run.waves[c.wave].rids)
    if not tokens:
        return None
    return sum(c.t1 - c.t0 for c in calls) * 1e3 / (tokens / 1e3)
