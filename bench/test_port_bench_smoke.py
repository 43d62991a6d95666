"""The harness end to end on the CPU at smoke size, against the plain
reference: every smoke cell, untraced and traced."""
import json
import time

import pytest
import torch

from bench import harness
from bench.testing import smoke_root

CELLS = ("smoke.moe-closed", "smoke.moe-open")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # one thread: the tiny model's ops gain nothing from more, and the
    # test workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield smoke_root(tmp_path_factory.mktemp("smoke"))
    torch.set_num_threads(threads)


@pytest.mark.parametrize("traced", (False, True))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees(root, cell, traced):
    result = harness.run_cell(root, cell, 2**31 + 17, 1.0, traced,
                              torch.device("cpu"), time.perf_counter(),
                              log=lambda m: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["logit_gap"]["value"] <= 1e-3
    bench = harness.Bench(root)
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in bench.metrics(cell, kind)}
    got = set(result["metrics"])
    assert got <= want
    if traced:
        # device metrics read nothing on the CPU and are left out
        assert {"decode_step_ms", "mfu.tok", "queue_wait_ms"} <= got
        assert "moe_roofline.tok" not in got
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"serve_tok_s", "tpot_p95_ms", "ttft_p95_ms",
                "setup_s"} == got
        assert all(v["value"] > 0 for v in result["metrics"].values())
    json.loads(json.dumps(result))


def test_same_seed_serves_the_same_tokens(root):
    def served(seed):
        bench = harness.Bench(root)
        cell = harness.build(bench, "smoke.moe-closed", seed, 0.3,
                             torch.device("cpu"))
        run = harness.window(cell, 0.3, False)
        return {rid: r.out for rid, r in run.requests.items() if r.out}
    a, b = served(5), served(5)
    common = set(a) & set(b)
    assert common and all(a[r] == b[r] for r in common)
