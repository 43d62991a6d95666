"""moe_step_ms: the MoE layers' device time a decode call, from the
port's device marks on ``moe.layer`` (``moe.moe_spec``), over the
window's decode calls."""
from bench.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "moe.layer")
