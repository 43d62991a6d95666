"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and entries only: the harness lists and runs
them with no other edit."""
import json
import shutil
import time

import torch

from bench import harness
from bench.testing import MOE, config_file, smoke_root

READER = '''"""waves_served: waves started inside the window."""


def read(run):
    return float(sum(1 for w in run.waves if w.start < run.t_end))
'''


def test_new_files_and_entries_only(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _new_files_and_entries_only(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _new_files_and_entries_only(tmp_path):
    root = smoke_root(tmp_path / "before")
    after = tmp_path / "after"
    shutil.copytree(root, after)
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    data = after / "bench"
    # a configuration of its own: fewer experts, one a token, no shared one
    port = dict(MOE, name="smoke-moe-top1", top_k=1, n_experts=2,
                n_shared_experts=0)
    (data / "configs" / "smoke-moe-top1.json").write_text(
        json.dumps(config_file(port, "smoke-moe-top1")))
    # a mix of its own: bursts as a fast open loop with long answers
    (data / "traffic" / "smoke-burst.json").write_text(json.dumps({
        "loop": "open", "rate": 80.0, "slots": 3,
        "prompt": {"dist": "uniform", "lo": 3, "hi": 9},
        "output": {"dist": "loguniform", "lo": 2, "hi": 7},
        "check": {"waves": 1, "requests": 2}}))
    # a per-layer metric of its own
    (data / "metrics" / "waves_served.py").write_text(READER)
    spec = json.loads((after / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "smoke-moe-top1", "source": "smoke",
                            "file": "bench/configs/smoke-moe-top1.json",
                            "reduced": [], "why": "added by files"})
    spec["workloads"].append({"name": "smoke.top1-burst",
                              "config": "smoke-moe-top1",
                              "traffic": "smoke-burst", "chips": 1,
                              "why": "added by files"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("smoke.top1-burst")
    spec["per_layer"].append({"name": "waves_served", "unit": "waves",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving engine",
                              "moves": "ttft_p95_ms",
                              "workloads": ["smoke.top1-burst"]})
    (after / "BENCHMARK.json").write_text(json.dumps(spec))
    # every file that was there is unchanged, apart from BENCHMARK.json's
    # new entries
    for rel, body in before.items():
        if rel.name != "BENCHMARK.json":
            assert (after / rel).read_bytes() == body, rel
    bench = harness.Bench(after)
    names = {m["name"] for m in bench.metrics("smoke.top1-burst",
                                              "per_layer")}
    assert "waves_served" in names
    for traced in (False, True):
        result = harness.run_cell(after, "smoke.top1-burst", 4, 0.4, traced,
                                  torch.device("cpu"), time.perf_counter(),
                                  log=lambda m: None)
        assert result["correct"], result["checks"]
        if traced:
            assert result["metrics"]["waves_served"]["value"] >= 1
        else:
            assert "ttft_p95_ms" in result["metrics"]
    # the cells that were there still run as before
    result = harness.run_cell(after, "smoke.moe-closed", 4, 0.3, False,
                              torch.device("cpu"), time.perf_counter(),
                              log=lambda m: None)
    assert result["correct"]
