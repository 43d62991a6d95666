"""moe_roofline: the MoE layer's least time, by the yardstick's count of
what its inputs need (router, shared expert and the experts its tokens
touch, read once; activations in and out; FLOPs of the router, the routed
pairs and the shared expert), over the device time of the work inside
the benchmark's ``bench.moe`` ranges, in percent.  Calls inside the
traced window only."""
from bench import yardstick as Y


def read(run):
    if run.trace is None or not run.probes.get("moe"):
        return None
    busy = run.trace.range_busy_s.get("bench.moe", 0.0)
    if busy <= 0:
        return None
    port = run.port
    ff = port.get("moe_d_ff") or port["d_ff"]
    calls = [(n, chosen) for t, n, chosen in run.probes["moe"]
             if run.t0 <= t < run.t_end]
    if not calls:
        return None
    bound = 0.0
    for n, chosen in calls:
        touched = int(chosen.reshape(-1).unique().numel())
        w = Y.moe_work(n, touched, d=port["d_model"],
                       n_experts=port["n_experts"], top_k=port["top_k"],
                       ff=ff, shared_ff=ff * port.get("n_shared_experts", 0))
        bound += Y.bf16_bound_s(w["flops"], w["bytes"])
    return bound / busy * 100
