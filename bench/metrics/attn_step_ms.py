"""attn_step_ms: the attention sublayers' device time a decode call, from
the port's device marks on ``model.attn`` (CUDA events at the span's
edges, resolved on the host clock), over the window's decode calls."""
from bench.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "model.attn")
