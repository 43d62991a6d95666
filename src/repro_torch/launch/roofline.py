"""Roofline analysis over the port's dry-run artifacts.

The counterpart of the JAX package's ``launch/roofline.py``: the same
:class:`Roofline` fields and the same :func:`analyze` arithmetic, with
the constants of one NVIDIA H100 SXM 80GB HBM3 (NVIDIA's data sheet,
dense rates, at its 700 W limit) in place of the TPU's.  Per (arch x
shape), from the single-pod record of :mod:`repro_torch.launch.dryrun`:

    compute    = FLOPs(global) / (chips x 989 TFLOP/s bf16)
    memory     = matmul bytes(global) / (chips x 3.35 TB/s HBM3)
    collective = collective bytes(global) / (chips x 450 GB/s NVLink,
                 one direction)

The records are per device (the cost counter of
:mod:`repro_torch.launch.cost` counts each rank's local work); they are
multiplied back to fleet-global and normalised per chip, so the terms
are comparable wall-time estimates for one step.  They are bounds from
counted work, not times measured on any card.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

#: H100 SXM 80GB HBM3: dense bfloat16 tensor-core rate, FLOP/s
H100_SXM_BF16_FLOPS = 989e12
#: H100 SXM 80GB HBM3: device-memory rate, bytes/s
H100_SXM_HBM3_BW = 3.35e12
#: H100 SXM: NVLink 4 (18 links), bytes/s in one direction
H100_SXM_NVLINK_BW = 450e9

RESULTS = os.path.join(os.path.dirname(__file__), "../../..", "results",
                       "dryrun_torch")


@dataclass
class Roofline:
    arch: str
    shape: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    step_time_s: float
    mfu: float
    skipped: Optional[str] = None

    def row(self) -> str:
        if self.skipped:
            return (f"{self.arch:24s} {self.shape:12s} SKIP: "
                    f"{self.skipped[:60]}")
        return (f"{self.arch:24s} {self.shape:12s} "
                f"{self.compute_s*1e3:9.2f} {self.memory_s*1e3:9.2f} "
                f"{self.collective_s*1e3:9.2f} {self.dominant:10s} "
                f"{self.useful_ratio:6.2f} {100*self.mfu:6.1f}%")


def tokens_of(shape: str) -> int:
    from .dryrun import SHAPES
    info = SHAPES[shape]
    return info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)


def analyze(rec: Dict) -> Roofline:
    """The roofline terms of one dry-run record.  ``hlo_flops_global``
    keeps the reference's field name: here it is the counted FLOPs of
    every rank."""
    if "skipped" in rec:
        return Roofline(rec["arch"], rec["shape"], 0, 0, 0, 0, "-", 0, 0, 0,
                        0, 0, skipped=rec["skipped"])
    n = rec["n_devices"]
    flops_g = rec["flops"] * n           # per-device -> global
    bytes_g = rec["bytes_accessed"] * n
    coll_g = rec["collective_bytes"]["total"] * n

    compute = flops_g / (n * H100_SXM_BF16_FLOPS)
    memory = bytes_g / (n * H100_SXM_HBM3_BW)
    collective = coll_g / (n * H100_SXM_NVLINK_BW)
    dominant = max(
        (("compute", compute), ("memory", memory),
         ("collective", collective)), key=lambda kv: kv[1])[0]

    tokens = tokens_of(rec["shape"])
    mult = 3 if rec["shape"].startswith("train") else 1  # fwd+bwd
    model_flops = 2 * mult * rec["params_active"] * tokens
    useful = model_flops / flops_g if flops_g else 0.0
    step = max(compute, memory, collective)
    mfu = model_flops / (step * n * H100_SXM_BF16_FLOPS) if step else 0.0
    return Roofline(rec["arch"], rec["shape"], n, compute, memory,
                    collective, dominant, model_flops, flops_g, useful,
                    step, mfu)


def load_all(mesh: str = "single") -> List[Roofline]:
    out = []
    for p in sorted(glob.glob(os.path.join(RESULTS, f"*__{mesh}.json"))):
        with open(p) as fh:
            out.append(analyze(json.load(fh)))
    return out


def main() -> str:
    rows = load_all()
    hdr = (f"{'arch':24s} {'shape':12s} {'comp_ms':>9s} {'mem_ms':>9s} "
           f"{'coll_ms':>9s} {'dominant':10s} {'useful':>6s} {'MFU':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(r.row())
    live = [r for r in rows if not r.skipped]
    if live:
        worst = min(live, key=lambda r: r.mfu)
        coll = max(live, key=lambda r: (r.collective_s /
                                        max(r.step_time_s, 1e-12)))
        print(f"\nworst MFU: {worst.arch} x {worst.shape} "
              f"({100*worst.mfu:.1f}%)")
        print(f"most collective-bound: {coll.arch} x {coll.shape}")
        return f"cells={len(live)},worst_mfu={100*worst.mfu:.1f}%"
    return "no_results"


if __name__ == "__main__":
    main()
