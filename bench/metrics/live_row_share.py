"""live_row_share: of the rows the window's decode steps computed, the
share whose request still needed the step's token, in percent: the sum
of the ``engine.commit`` spans' ``live_rows`` over the sum of their
``rows`` (a wave runs to its longest answer)."""
from bench.program_spans import named, window_spans


def read(run):
    commits = [s for s in named(window_spans(run), "engine.commit")
               if "rows" in s.attrs]
    rows = sum(s.attrs["rows"] for s in commits)
    if not rows:
        return None
    return sum(s.attrs["live_rows"] for s in commits) / rows * 100
