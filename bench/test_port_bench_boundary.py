"""Nothing the benchmark loads is JAX or the JAX package: module names
are compared by their whole top-level name, so ``repro_torch`` passes."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@pytest.mark.parametrize("name, bad", [
    ("repro_torch", False), ("repro_torch.serve.engine", False),
    ("reprox", False), ("jax_helpers", False), ("repro", True),
    ("repro.core.ir", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True)])
def test_top_level_names_compared_whole(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, sys)
    assert (name in harness.forbidden_modules()) == bad


def test_a_run_loads_no_jax_in_a_fresh_process():
    code = (
        "import sys, torch, json\n"
        "from bench import harness, serve, trace, traffic, weights, "
        "yardstick, calibrate, run\n"
        "from bench.testing import smoke_root\n"
        "import tempfile, time\n"
        "root = smoke_root(tempfile.mkdtemp())\n"
        "r = harness.run_cell(root, 'smoke.moe-closed', 3, 0.2, True,"
        " torch.device('cpu'), time.perf_counter(), log=lambda m: None)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "references").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "typing", "torch"}, path


def test_the_cli_refuses_without_a_card():
    if subprocess.run([sys.executable, "-c",
                       "import torch, sys; "
                       "sys.exit(0 if torch.cuda.is_available() else 1)"],
                      capture_output=True).returncode == 0:
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload",
         "kimi-k2.decode-batch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
