"""Split the chunked-attention ``head`` route's time on the card into the
launch, the bulk load and the rest.

``csrc/chunked_attention_head.cu`` runs a head's attention in one block:
thread 0 starts the bulk copies of the head's operands onto one mbarrier,
every thread waits on it, then the block computes and stores.  At the
smoke shapes the route's byte bound is a few nanoseconds, so what a
launch takes is latency.  This script times, at the route's two main
paths' shapes (:data:`SHAPES`: the smoke configs' float32 attention and
Jamba's smoke config in bf16, causal), forward and backward, by CUDA-graph
replay of back-to-back launches, the three alternating round by round:

* ``floor``: a one-element ``zero_``, the launch floor ``chip_smoke.py``
  prints beside the route;
* ``load only``: the kernel built to return right after its mbarrier
  wait (:data:`VARIANTS`: a copy of the source with one line added after
  each body's wait, each replacement matching once): the launch, the
  copies and the wait;
* ``whole``: the shipped kernel.

Run on one H100 (it needs ``nvcc``; it writes under ``build/``):

    PYTHONPATH=src python -m repro_torch.launch.attn_head_latency [--rounds 5]
"""
from __future__ import annotations

import argparse
import json
import statistics

from repro_torch.kernels import build
from repro_torch.launch import variants

LIB = "chunked_attention_head"
_WAIT = "  hopper::mbar_wait(hopper::smem_addr(smem), 0);\n"
_RETURN = "  if (a.tk > 0) return;  // load only\n"
#: the text just before each of the four bodies' mbarrier wait (bf16
#: forward and backward, float32 forward and backward)
_BEFORE_WAIT = (
    "  zero_tail<bf16>(smem + L.v, a.tk);\n  __syncthreads();\n",
    "  const float lse_i = i < a.tq ? a.lse[bh * a.tq + i] : 0.f;\n"
    "  __syncthreads();\n",
    "  zero_tail<float>(smem + L.v, a.tk);\n  __syncthreads();\n",
    "  const float lse_x = x < a.tq ? a.lse[bh * a.tq + x] : 0.f;\n"
    "  __syncthreads();\n",
)
VARIANTS = {
    "whole": [],
    "load only": [(b + _WAIT, b + _WAIT + _RETURN) for b in _BEFORE_WAIT],
}
#: B, H, T (queries and keys), dtype name: [train-small]'s float32 smoke
#: attention and [train-ssm]'s Jamba run in bf16; d 16
SHAPES = ((2, 4, 16, "float32"), (2, 4, 64, "bfloat16"))
D = 16


def _graph_us(fn, reps: int, replays: int = 5) -> float:
    """Mean device µs of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, CUDA events around ``replays`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays) * 1e3


def main(argv=None) -> dict:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_head_latency: needs a CUDA device")
    card = variants.card()
    libs = variants.build_all(LIB, VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(28)
    z = torch.zeros(1, device="cuda")
    result = {"card": card, "us": {}}
    for b, h, t, dtype_name in SHAPES:
        dtype = getattr(torch, dtype_name)
        tag = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, o, dout, dq, dk, dv = (
            torch.randn((b, h, t, D), generator=gen, device="cuda").to(dtype)
            for _ in range(8))
        lse = torch.zeros((b, h, t), device="cuda")
        shape = (b * h, t, t, D, 1, 0)

        def fwd(lib):
            err = getattr(lib, f"chunked_attention_head_fwd_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *shape, torch.cuda.current_stream().cuda_stream)
            build.check(err, "head forward")

        def bwd(lib):
            err = getattr(lib, f"chunked_attention_head_bwd_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *shape,
                torch.cuda.current_stream().cuda_stream)
            build.check(err, "head backward")

        fwd(libs["whole"])  # out and lse for the backward
        times = {"floor": []}
        for way in ("fwd", "bwd"):
            for name in libs:
                times[f"{name} {way}"] = []
        for _ in range(args.rounds):
            times["floor"].append(_graph_us(z.zero_, args.reps))
            for name, lib in libs.items():
                times[f"{name} fwd"].append(
                    _graph_us(lambda: fwd(lib), args.reps))
                times[f"{name} bwd"].append(
                    _graph_us(lambda: bwd(lib), args.reps))
        key = f"{b}x{h}x{t}x{t} {dtype_name}"
        result["us"][key] = {n: {"median": statistics.median(v), "all": v}
                             for n, v in times.items()}
        print(f"[head-latency] {key}, d {D}, causal: us a launch, median of "
              f"{args.rounds} rounds of {args.reps} (min, max): " + "; ".join(
                  f"{n} {statistics.median(v):.3f} ({min(v):.3f}, "
                  f"{max(v):.3f})" for n, v in times.items())
              + f" ({card})")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
