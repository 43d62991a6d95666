"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a chip skipped, the rest of a run driven on the
CPU at smoke size), and the float8 control fails the limit the program
passes, in a closed and an open loop.  Faults of a served model: a token
altered where it is produced; a decode step that returns its state (the
KV cache) unchanged; half of the batch's rows left out of the MoE layer.
The exchange between chips does not exist on the benchmark's one-chip
cells."""
import time

import pytest
import torch

from bench import harness
from bench.testing import SMOKE_GAP, smoke_root
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model

CELLS = ("smoke.moe-closed", "smoke.moe-open")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield smoke_root(tmp_path_factory.mktemp("faults"))
    torch.set_num_threads(threads)


def _run(root, cell):
    return harness.run_cell(root, cell, 23, 0.4, False, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None)


def altered_token(monkeypatch):
    real = Model.decode_step

    def decode_step(self, *args, **kw):
        out = real(self, *args, **kw)
        logits = out[0].clone()
        logits[:, 0] = logits.max() + 1.0     # every row serves token 0
        return (logits,) + tuple(out[1:])
    monkeypatch.setattr(Model, "decode_step", decode_step)


def state_unchanged(monkeypatch):
    real = Model.decode_step

    def decode_step(self, params, cache, *args, **kw):
        saved = [[(k.clone(), v.clone()) for k, v in g] for g in cache[0]]
        out = real(self, params, cache, *args, **kw)
        for g, kvs in zip(out[1][0], saved):
            for (k, v), (k0, v0) in zip(g, kvs):
                k.copy_(k0)
                v.copy_(v0)
        return out
    monkeypatch.setattr(Model, "decode_step", decode_step)


def half_batch(monkeypatch):
    real = moe_mod.moe_spec

    def moe_spec(params, x, **kw):
        res = real(params, x, **kw)
        out = res[0] if isinstance(res, tuple) else res
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return (out,) + tuple(res[1:]) if isinstance(res, tuple) else out
    monkeypatch.setattr(moe_mod, "moe_spec", moe_spec)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", (altered_token, state_unchanged,
                                   half_batch))
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = _run(root, cell)
    assert result["correct"] is False
    assert result["checks"]["logit_gap"]["value"] > SMOKE_GAP


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    assert _run(root, cell)["correct"] is True


@pytest.mark.parametrize("seed", (1, 2, 3, 4, 2**31 + 9, 2**40 + 1))
def test_float8_control_fails_the_limit(root, seed):
    # the closed loop: answers of 6-12 tokens give the control enough
    # positions to put another token first
    cell = "smoke.moe-closed"
    bench = harness.Bench(root)
    built = harness.build(bench, cell, seed, 0.3, torch.device("cpu"))
    run = harness.window(built, 0.3, False)
    verdict = harness.judge(built, run, seed, modes=("fp8",),
                            log=lambda m: None)
    assert verdict["correct"]
    # the control, judged in the program's place by the same checks
    control = verdict["modes"]["fp8"]
    assert control["correct"] is False
    assert control["checks"]["logit_gap"]["limit"] == SMOKE_GAP
    assert max(verdict["gaps"]) <= SMOKE_GAP \
        < control["checks"]["logit_gap"]["value"]
