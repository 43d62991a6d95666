"""Time the RWKV-6 chunked forward's staging of r, k and w, one buffer
against two, in bf16 and in float32.

``csrc/rwkv6_chunk_sm90.cu`` stages each 16-token chunk of r, k, v and w
in shared memory by ``cp.async``.  v always has two buffers.  r, k and w
can have one (the next chunk's load waits until the scores have read
this one's, and overlaps only the tensor-core products: 40.7 KB of
shared memory a block in bf16, 52.2 KB in float32) or two (the load
overlaps the whole chunk: 47.6 KB in bf16, and 66.0 KB in float32, which
leaves three blocks an SM where the kernel asks for four).  The source
ships one.  This script builds the source in both layouts
(:data:`VARIANTS`: the layout the source does not ship is made by
replacing a few lines of a copy of it, each of which must match once),
checks that both give the same state and y bit for bit, and times each
layout in each dtype at one RWKV-6-7B layer's prefill (B = 8, T = 512,
64 heads of 64), CUDA events around back-to-back launches, the layouts
alternating round by round.

Run on one H100 (it needs ``nvcc``; it writes under ``build/``):

    PYTHONPATH=src python -m repro_torch.launch.rwkv6_staging [--rounds 7]
"""
from __future__ import annotations

import argparse
import json
import statistics

from repro_torch.kernels import build
from repro_torch.launch import variants

LIB = "rwkv6_chunk_sm90"
#: each layout as replacements of the shipped source's text (the source
#: ships one buffer of r, k and w)
VARIANTS = {
    "one buffer": [],
    "two buffers": [
        ("  T rkw[3][kC][kP];                  // r, k, w of a chunk (one "
         "buffer)",
         "  T rkw[2][3][kC][kP];               // r, k, w of a chunk, two "
         "buffers"),
        ("""  const auto load_rkw = [&](int64_t c) {
    stage(sm.rkw[0], r, c);
    stage(sm.rkw[1], k, c);
    stage(sm.rkw[2], w, c);""", """  const auto load_rkw = [&](int64_t c, int buf) {
    stage(sm.rkw[buf][0], r, c);
    stage(sm.rkw[buf][1], k, c);
    stage(sm.rkw[buf][2], w, c);"""),
        ("  load_rkw(0);\n", "  load_rkw(0, 0);\n"),
        # the next chunk's r, k and w load beside its v, at the top
        ("    if (c + 1 < n_c) load_v(c + 1, st ^ 1);\n",
         "    if (c + 1 < n_c) {\n      load_rkw(c + 1, st ^ 1);\n"
         "      load_v(c + 1, st ^ 1);\n    }\n"),
        ("""    const Row in_r = sm.rkw[0];
    const Row in_k = sm.rkw[1];
    const Row in_w = sm.rkw[2];""", """    const Row in_r = sm.rkw[st][0];
    const Row in_k = sm.rkw[st][1];
    const Row in_w = sm.rkw[st][2];"""),
        ("    if (c + 1 < n_c) load_rkw(c + 1);\n", ""),
    ],
}
#: B, T, heads, head width: one RWKV-6-7B layer's prefill
SHAPE = (8, 512, 64, 64)


def _source(subs) -> str:
    return variants.source(LIB, subs)


def _build_all() -> dict:
    """Each layout's library, built in parallel beside the kernels'."""
    return variants.build_all(LIB, VARIANTS)


def _inputs(dtype, gen):
    import torch
    b, t, h, hd = SHAPE
    dev = torch.device("cuda")

    def f(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)
    w = torch.sigmoid(torch.randn((b, t, h, hd), generator=gen, device=dev)
                      + 2).to(dtype)
    return [f(b, t, h, hd, scale=0.5), f(b, t, h, hd, scale=0.5),
            f(b, t, h, hd), w, f(h, hd, scale=0.5),
            torch.randn((b, h, hd, hd), generator=gen, device=dev) * 0.3]


def main(argv=None) -> dict:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rwkv6_staging: needs a CUDA device")
    card = variants.card()
    libs = _build_all()
    gen = torch.Generator(device="cuda").manual_seed(27)
    b, t, h, hd = SHAPE
    result = {"card": card, "shape": list(SHAPE), "us": {}}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        ins = _inputs(dtype, gen)
        outs = {n: (torch.empty_like(ins[5]), torch.empty_like(ins[0]))
                for n in libs}
        stream = torch.cuda.current_stream().cuda_stream

        def launch(name):
            s, y = outs[name]
            err = getattr(libs[name], f"rwkv6_scan_chunked_{tag}")(
                *[a.data_ptr() for a in ins], y.data_ptr(), s.data_ptr(),
                b, t, h, hd, stream)
            build.check(err, f"rwkv6_scan_chunked_{tag} ({name})")

        for name in libs:
            launch(name)
        torch.cuda.synchronize()
        first, *rest = libs
        for name in rest:
            for i, what in enumerate(("state", "y")):
                if not torch.equal(outs[name][i], outs[first][i]):
                    raise SystemExit(f"{tag} {what}: {name} differs from "
                                     f"{first}")
        times = {n: [] for n in libs}
        for _ in range(args.rounds):
            for name in libs:
                for _ in range(3):
                    launch(name)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    launch(name)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / args.reps
                                   * 1e3)
        result["us"][tag] = {n: {"median": statistics.median(v), "all": v}
                             for n, v in times.items()}
        print(f"[staging] {tag} B={b} T={t} H={h} hd={hd}, state and y "
              f"bitwise equal across layouts; us a launch, median of "
              f"{args.rounds} rounds of {args.reps} (min, max): " + "; ".join(
                  f"{n} {statistics.median(v):.2f} ({min(v):.2f}, "
                  f"{max(v):.2f})" for n, v in times.items())
              + f" ({card})")
        del ins, outs
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
