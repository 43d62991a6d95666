"""Make ``mamba_du_t1_draw.npz``: the float32 Mamba draw at T = 1 on
which ``chip_smoke.py``'s step-pair sweep held the pair's du to the
float32 loop's at 1e-4 of max|du| and failed.

``chip_smoke.phase_scan`` draws the sweeps' inputs from one generator
(seed 25).  Its step-forward sweep now draws from a generator of its own;
when it drew from the shared one, after the RWKV-6 step-pair sweep, the
Mamba step-pair sweep's first float32 draw (T = 1, B 2, 8192 channels,
the models' decay regime) was this one.  The script replays
``phase_scan`` in that order on the card up to the Mamba step-pair sweep
(every earlier phase of it runs in full), draws the case as the sweep
does, with the cotangent of y from seed 8 and none of the last state,
prints the pair's du against the float32 loop's and each against the loop
in float64, and writes the inputs, the cotangent and the generator's
(seed, Philox offset) to the path given, by default beside this file.

Run from the repository root on one H100 (about five minutes)::

    python3 tests/data/make_mamba_du_t1_draw.py [OUT.npz]
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "..", "src"),
                os.path.join(HERE, "..", "..")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ref, scan  # noqa: E402

#: the cotangent seed of the step-pair sweep at T = 1 (``7 + t``)
COT_SEED = 8


class _Reached(Exception):
    pass


def _du(fn, args, dy):
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    _, y = fn(*xs)
    return torch.autograd.grad([y], xs[0], [dy.to(y.dtype)])[0]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    shared = {}
    draw = cs._scan_args

    def scan_args(kind, b, t, width, dtype, gen, *args, **kw):
        shared.setdefault("gen", gen)  # phase_scan's first draw
        return draw(kind, b, t, width, dtype, gen, *args, **kw)

    fwd_sweep, bwd_sweep = cs._step_fwd_sweep, cs._step_bwd_sweep
    found = {}

    def step_bwd_sweep(kind, k, gen):
        if kind != "mamba":
            return bwd_sweep(kind, k, gen)
        state = gen.get_state().clone()
        b, t, width, _ = cs.STEP_BWD_EDGES["mamba"][0]
        args = draw(kind, b, t, width, torch.float32, gen, "model")
        s, y = ref.mamba_scan(*args)
        _, dy = cs._scan_cots(s, y, COT_SEED)
        found.update(args=args, dy=dy, state=state)
        raise _Reached

    cs._scan_args = scan_args
    cs._step_fwd_sweep = lambda kind, k, gen: fwd_sweep(kind, k,
                                                       shared["gen"])
    cs._step_bwd_sweep = step_bwd_sweep
    cs.phase_build()
    try:
        cs.phase_scan()
    except _Reached:
        pass
    args, dy = found["args"], found["dy"]
    got = _du(scan.mamba_scan, args, dy)
    loop = _du(ref.mamba_scan, args, dy)
    wide = _du(ref.mamba_scan, [a.double() for a in args], dy)
    big = loop.abs().max().item()
    st = found["state"].cpu().numpy()
    seed = int.from_bytes(st[:8].tobytes(), "little")
    offset = int.from_bytes(st[8:].tobytes(), "little")
    print(f"generator seed {seed}, Philox offset {offset}; max|du| {big:.6g}"
          f" (1e-4 of it {1e-4 * big:.4g}); the pair's du against the float32"
          f" loop's {(got - loop).abs().max().item():.4g}; against the loop "
          f"in float64: the pair {(got.double() - wide).abs().max().item():.4g}"
          f", the float32 loop {(loop.double() - wide).abs().max().item():.4g}")
    u, delta, bmat, cmat, a, s0 = (x.cpu().numpy() for x in args)
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        HERE, "mamba_du_t1_draw.npz")
    np.savez_compressed(out, u=u,
                        delta=delta, bmat=bmat, cmat=cmat, a=a, s0=s0,
                        dy=dy.cpu().numpy(),
                        generator=np.array([seed, offset], dtype=np.int64),
                        cotangent_seed=np.array(COT_SEED, dtype=np.int64))


if __name__ == "__main__":
    main()
