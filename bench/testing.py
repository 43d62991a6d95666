"""A benchmark root at CPU smoke size, for the benchmark's own tests.

``smoke_root(tmp)`` copies the benchmark's metric readers and references
under ``tmp/bench``, writes a tiny configuration of the family the
benchmark runs (float32) and two mixes, a closed and an open loop, and a
``BENCHMARK.json`` that names them with the real file's metrics.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

MOE = {"name": "smoke-moe", "family": "moe", "n_layers": 2, "d_model": 64,
       "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 512,
       "n_experts": 4, "top_k": 2, "moe_d_ff": 64, "n_shared_experts": 1,
       "capacity_factor": 1.25, "rope_theta": 10000.0, "head_dim": 16,
       "dtype": "float32"}
CLOSED = {"loop": "closed", "clients": 4, "slots": 4,
          "prompt": {"dist": "loguniform", "lo": 4, "hi": 12},
          "output": {"dist": "uniform", "lo": 6, "hi": 12},
          "check": {"waves": 2, "requests": 4}}
OPEN = {"loop": "open", "rate": 40.0, "slots": 4,
        "prompt": {"dist": "uniform", "lo": 4, "hi": 12},
        "output": {"dist": "uniform", "lo": 2, "hi": 5},
        "check": {"waves": 2, "requests": 2}}

#: float32 on the CPU against the float32 reference: summation order only
SMOKE_GAP = 1e-3


def config_file(port, name, gap=SMOKE_GAP):
    return {"name": name, "source": "smoke", "reduced": {}, "assumed": {},
            "departures": [], "deployment": "a CPU test",
            "reference": "stack", "port": port,
            "check": {"logit_gap": gap}}


def smoke_root(tmp, cells=None, extra_metrics=()) -> Path:
    """A root under ``tmp`` whose ``BENCHMARK.json`` holds the smoke
    cells ``smoke.moe-closed`` and ``smoke.moe-open``."""
    tmp = Path(tmp)
    data = tmp / "bench"
    for sub in ("metrics", "references"):
        shutil.copytree(BENCH / sub, data / sub, dirs_exist_ok=True)
    (data / "configs").mkdir(parents=True, exist_ok=True)
    (data / "traffic").mkdir(parents=True, exist_ok=True)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = []
    for name, port in (("smoke-moe", MOE),):
        path = data / "configs" / f"{name}.json"
        path.write_text(json.dumps(config_file(port, name)))
        configs.append({"name": name, "source": "smoke",
                        "file": f"bench/configs/{name}.json",
                        "reduced": [], "why": "CPU smoke size"})
    for name, mix in (("smoke-closed", CLOSED), ("smoke-open", OPEN)):
        (data / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = cells or [("smoke.moe-closed", "smoke-moe", "smoke-closed"),
                      ("smoke.moe-open", "smoke-moe", "smoke-open")]
    names = [c[0] for c in cells]
    spec = dict(real)
    spec["configs"] = configs
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "CPU smoke"} for n, c, t in cells]
    spec["end_to_end"] = [dict(m, workloads=names) if "workloads" in m
                          else dict(m) for m in real["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=names) for m in
                         list(real["per_layer"]) + list(extra_metrics)]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
