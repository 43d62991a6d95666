"""moe_touched_share: of the expert weights the window's decode calls
read, the share their tokens chose, in percent: the sum of the
``moe.layer`` spans' ``experts_touched`` (the distinct experts of the
port's own routing, counted on the device) over the sum of their
``experts_read`` (every expert, for the batched expert FFN)."""
from bench.program_spans import in_decode, window_spans


def read(run):
    layers = [s for v in in_decode(window_spans(run), "moe.layer").values()
              for s in v if "experts_touched" in s.attrs]
    read_ = sum(s.attrs["experts_read"] for s in layers)
    if not read_:
        return None
    return sum(s.attrs["experts_touched"] for s in layers) / read_ * 100
