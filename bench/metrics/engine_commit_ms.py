"""engine_commit_ms: the serving engine's own host work a decode step,
the mean over the window's ``engine.commit`` spans that precede a decode
call (``Engine._run_wave``: the argmax readback, with the device's wait
where the caller did not synchronise, the token appends, the truncation
checks)."""
from bench.program_spans import named, window_spans


def read(run):
    commits = [s for s in named(window_spans(run), "engine.commit")
               if "rows" in s.attrs]
    if not commits:
        return None
    return sum(s.t1 - s.t0 for s in commits) / len(commits) / 1e6
