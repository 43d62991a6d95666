"""decode_step_ms: synced host time of the decode calls inside the
window over their number (Model.decode_step)."""


def read(run):
    calls = run.calls_in_window("decode")
    if not calls:
        return None
    return sum(c.t1 - c.t0 for c in calls) / len(calls) * 1e3
