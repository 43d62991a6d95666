"""The port's data pipeline, checkpoints, fault monitor, trainer and train
launcher, on the CPU.

* ``SyntheticLM.batch_at`` bit for bit equal to the reference's (several
  configs, steps and host shards), and the reference's data checks
  (``tests/test_substrate.py``) on the port: deterministic and seekable,
  host shards disjoint, the prefetcher;
* checkpoints: the reference's round trip, atomicity, keep/gc, async
  and elastic (``shard_fn``) checks, then the port's own format: a
  ``TrainState`` with optimizer state, float32 and bfloat16 tensors and
  an int32 step comes back as plain dictionaries and lists of CPU
  tensors of the same dtypes and bits (``torch.load(weights_only=True)``),
  the snapshot is a copy that later in-place updates do not reach, and
  an error on the writer thread comes back from ``wait``;
* the fault monitor: the reference's checks, and the same decisions and
  events as the reference's monitor on the same clock, beats and armed
  fault plan;
* the trainer: the reference's convergence and restart-continuity checks
  (``tests/test_system.py``) on the CPU, the periodic async checkpoints,
  and ``device=None`` meaning the card, which raises without one;
* the launcher: ``--smoke --steps 5 --device cpu`` runs; without
  ``--device`` it raises when there is no card.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.resilience import faults as rfaults
from repro.resilience.faults import FaultPlan as RFaultPlan
from repro.train.fault import FaultConfig as RFaultConfig
from repro.train.fault import FaultMonitor as RFaultMonitor
from repro.train.fault import plan_remesh as rplan_remesh
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.resilience import faults
from repro_torch.resilience.faults import FaultPlan
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import FaultConfig, FaultMonitor, plan_remesh
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          state_from_tree)
from repro_torch.train.trainer import TrainerConfig, train

# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=64, global_batch=8),
    dict(vocab=200064, seq_len=256, global_batch=8),
    dict(vocab=1000, seq_len=17, global_batch=6, seed=3, n_hosts=3,
         host_id=2),
])
def test_batch_at_matches_reference_bitwise(kw):
    got, want = SyntheticLM(DataConfig(**kw)), RSyntheticLM(RDataConfig(**kw))
    assert got.per_host == want.per_host
    for step in (0, 1, 7, 12345):
        g, w = got.batch_at(step), want.batch_at(step)
        assert g.keys() == w.keys()
        assert g["tokens"].dtype == w["tokens"].dtype == np.int32
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_data_deterministic_and_seekable():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=4)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    np.testing.assert_array_equal(d1.batch_at(42)["tokens"],
                                  d2.batch_at(42)["tokens"])
    assert not np.array_equal(d1.batch_at(1)["tokens"],
                              d1.batch_at(2)["tokens"])


def test_data_host_sharding_disjoint():
    a = SyntheticLM(DataConfig(vocab=100, seq_len=8, global_batch=8,
                               n_hosts=2, host_id=0))
    b = SyntheticLM(DataConfig(vocab=100, seq_len=8, global_batch=8,
                               n_hosts=2, host_id=1))
    assert a.per_host == 4
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])


def test_prefetcher():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2)
    pf = Prefetcher(iter(SyntheticLM(cfg)), depth=2)
    b0 = next(pf)
    b1 = next(pf)
    assert b0["tokens"].shape == (2, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"],
                                  SyntheticLM(cfg).batch_at(1)["tokens"])
    pf.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(8.0), "step": torch.tensor(3)}
    mgr.save(3, state)
    mgr.save(7, state)
    mgr.save(11, state)
    assert mgr.latest_step() == 11
    assert mgr.all_steps() == [7, 11]  # gc kept 2
    back = mgr.restore()
    assert torch.equal(back["w"], torch.arange(8.0))
    assert int(back["step"]) == 3
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path / "step_11")) == ["meta.json",
                                                        "state.pt"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.ones((1024,))}
    mgr.save_async(1, state)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_elastic_reshard(tmp_path):
    """Save, restore with a shard_fn (the elastic-restart path)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.arange(16.0)})
    calls = []

    def shard_fn(tree):
        calls.append(True)
        return {k: v.to(torch.float64) for k, v in tree.items()}

    back = mgr.restore(shard_fn=shard_fn)
    assert calls and back["w"].shape == (16,)
    assert back["w"].dtype == torch.float64


def _train_state(dtype):
    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    init, _, name = make_train_step(build_model(cfg), compress=True)
    return init(torch.Generator().manual_seed(1), "cpu"), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_train_state_roundtrip_bitwise(tmp_path, dtype):
    """A whole TrainState (AdamW moments, the residual, an int32 step),
    bfloat16 included, comes back with every tensor's dtype and bits."""
    state, name = _train_state(dtype)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(4, state)
    mgr.wait()
    tree = mgr.restore(4)
    assert isinstance(tree, dict) and isinstance(tree["opt"], dict)
    assert isinstance(tree["params"]["groups"], list)
    back = state_from_tree(tree, name)
    assert isinstance(back.opt, AdamWState)
    want = ckpt_mod.snapshot(state)
    got = ckpt_mod.snapshot(back)
    flat_w, flat_g = [], []
    _flatten(want, flat_w)
    _flatten(got, flat_g)
    assert len(flat_w) == len(flat_g) > 0
    assert any(t.dtype == torch.bfloat16 for t in flat_g) == \
        (dtype == "bfloat16")
    for w, g in zip(flat_w, flat_g):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        assert g.shape == w.shape
        assert torch.equal(g.reshape(-1).view(torch.uint8),
                           w.reshape(-1).view(torch.uint8))
    assert back.step.dtype == torch.int32


def _flatten(tree, out):
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)


def test_checkpoint_snapshot_is_a_copy(tmp_path):
    """The optimizer updates the parameters in place, so the async
    snapshot must not be a view of them."""
    w = torch.zeros(4)
    state = TrainState({"w": w}, None, torch.zeros((), dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, state)
    w.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore()["params"]["w"], torch.zeros(4))


def test_checkpoint_writer_error_comes_back_from_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(obj, path):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt_mod.torch, "save", broken)
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # reported once
    assert mgr.latest_step() is None


# ---------------------------------------------------------------------------
# fault monitor
# ---------------------------------------------------------------------------


def test_fault_dead_host_detection():
    t = [0.0]
    mon = FaultMonitor(["a", "b"], FaultConfig(dead_after=10),
                       clock=lambda: t[0])
    t[0] = 5.0
    mon.heartbeat("a")
    t[0] = 12.0
    action, hosts = mon.decide()
    assert action == "RESTART_ELASTIC" and hosts == ["b"]


def test_fault_straggler_detection():
    mon = FaultMonitor(["a", "b", "c", "d"],
                       FaultConfig(straggler_factor=1.5, patience=2))
    for _ in range(4):
        for h in "abcd":
            mon.heartbeat(h)
            mon.report_step(h, 10.0 if h != "d" else 30.0)
        action, hosts = mon.decide()
    assert action == "REDISPATCH" and hosts == ["d"]


@pytest.mark.parametrize("n", [16, 240, 255, 511, 512, 777, 4096])
def test_plan_remesh_matches_reference(n):
    assert plan_remesh(n) == rplan_remesh(n)
    assert plan_remesh(n, model_size=8, pod_size=64) == \
        rplan_remesh(n, model_size=8, pod_size=64)


def test_plan_remesh_shrinks_data_axis_first():
    assert plan_remesh(512) == (2, 16, 16)
    assert plan_remesh(511) == (31, 16)      # lost a node: biggest fillable
    assert plan_remesh(240) == (15, 16)      # keep model axis whole
    assert plan_remesh(16) == (1, 16)


def test_fault_monitor_consumes_plan_and_records_events():
    t = [0.0]
    mon = FaultMonitor(["h0", "h1"], FaultConfig(dead_after=5.0),
                       clock=lambda: t[0])
    with faults.armed(FaultPlan({"train.heartbeat": 1.0}, seed=0)):
        for _ in range(4):
            t[0] += 2.0
            mon.heartbeat("h0")  # every beat dropped by the plan
            mon.hosts["h1"].last_beat = t[0]  # h1 beats out-of-band
        action, hosts = mon.decide()
    assert action == "RESTART_ELASTIC" and hosts == ["h0"]
    assert [e.site for e in mon.events] == ["train.heartbeat"]
    assert mon.events[0].rung == "fleet"


@pytest.mark.parametrize("rates", [{"train.straggler": 0.5},
                                   {"train.heartbeat": 0.3,
                                    "train.straggler": 0.2}])
def test_fault_monitor_matches_reference_under_a_plan(rates):
    """The same seeded plan, clock and beats: the same decisions, events
    and EWMAs in both packages."""
    runs = []
    for mod, Mon, Cfg, Plan in (
            (rfaults, RFaultMonitor, RFaultConfig, RFaultPlan),
            (faults, FaultMonitor, FaultConfig, FaultPlan)):
        t = [0.0]
        mon = Mon(["a", "b", "c"], Cfg(dead_after=7.0, patience=2),
                  clock=lambda: t[0])
        out = []
        with mod.armed(Plan(dict(rates), seed=11)):
            for i in range(12):
                t[0] += 1.0
                for h in "abc":
                    mon.heartbeat(h)
                    mon.report_step(h, 1.0 + 0.1 * i)
                out.append(mon.decide())
        runs.append((out, [(e.site, e.rung, e.cause, e.outcome)
                           for e in mon.events],
                     {h: s.ewma_step for h, s in mon.hosts.items()}))
    assert runs[0] == runs[1]
    assert runs[1][1]  # the plan fired


# ---------------------------------------------------------------------------
# trainer and launcher
# ---------------------------------------------------------------------------


def test_training_convergence():
    cfg = base.smoke(base.get("phi4_mini_3_8b"))
    model = build_model(cfg)
    init_state, train_step, opt_name = make_train_step(
        model, peak_lr=3e-3, warmup=10)
    assert opt_name == "adamw"
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8))
    losses = []
    for i in range(60):
        state, m = train_step(state, {k: torch.from_numpy(v)
                                      for k, v in data.batch_at(i).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]


def test_train_checkpoint_restart_continuity(tmp_path):
    """Crash-and-restart must resume from LATEST and keep improving."""
    cfg = base.smoke(base.get("stablelm_12b"))
    t1 = TrainerConfig(steps=20, ckpt_dir=str(tmp_path), ckpt_every=10,
                       global_batch=4, seq_len=32, peak_lr=2e-3, warmup=5)
    out1 = train(cfg, t1, device="cpu")
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 20]
    # "crash" — new trainer restores from the final checkpoint
    t2 = TrainerConfig(steps=40, ckpt_dir=str(tmp_path), ckpt_every=10,
                       global_batch=4, seq_len=32, peak_lr=2e-3, warmup=5)
    logs = []
    out2 = train(cfg, t2, log=logs.append, device="cpu")
    assert logs[0] == f"[trainer] restored step 20 from {tmp_path}"
    assert int(out2["state"].step) == 40
    assert len(out2["losses"]) == 20
    assert out2["final_loss"] <= out1["final_loss"] + 0.05
    assert CheckpointManager(str(tmp_path)).latest_step() == 40


def test_trainer_restores_the_saved_state_bitwise(tmp_path):
    """The restored state is the saved one: the same parameters, moments
    and step, on the asked device, and training from it continues as an
    uninterrupted run would."""
    cfg = base.smoke(base.get("granite_34b"))
    # all steps inside the warm-up, so the schedule does not depend on
    # TrainerConfig.steps
    kw = dict(ckpt_dir=str(tmp_path), global_batch=2, seq_len=16,
              warmup=10)
    train(cfg, TrainerConfig(steps=3, **kw), log=lambda s: None,
          device="cpu")
    whole = train(cfg, TrainerConfig(steps=5, global_batch=2, seq_len=16,
                                      warmup=10), log=lambda s: None,
                  device="cpu")
    resumed = train(cfg, TrainerConfig(steps=5, **kw), log=lambda s: None,
                    device="cpu")
    a, b = [], []
    _flatten(ckpt_mod.snapshot(whole["state"]), a)
    _flatten(ckpt_mod.snapshot(resumed["state"]), b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(base.smoke(base.get("phi4_mini_3_8b")), TrainerConfig(steps=1))


def test_launcher_smoke_on_cpu(capsys):
    assert launch_train.main(["--arch", "phi4-mini-3.8b", "--smoke",
                              "--steps", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[trainer] step     0 loss" in out
    assert "done: loss" in out and "(adamw," in out


def test_launcher_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "phi4-mini-3.8b", "--smoke",
                           "--steps", "1"])
