"""queue_wait_ms: the mean over the requests due in the window of the
time from a request's due time to the start of its wave (the
benchmark's own spans)."""


def read(run):
    waits = [r.start - r.due for r in run.due_in_window()
             if r.start is not None]
    return sum(waits) / len(waits) * 1e3 if waits else None
