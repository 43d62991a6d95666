"""serve_tok_s: output tokens handed to the host inside the window, a
second of the window (host clock)."""


def read(run):
    n = sum(1 for r in run.requests.values() for t in r.stamps
            if run.t0 <= t <= run.t_end)
    return n / run.seconds
