"""The training loop: seekable data, the train step, periodic async
checkpoints, fault-monitor hooks, restart-from-LATEST (counterpart of
the JAX package's ``train/trainer.py``).  Single-process here.

``device=None`` means ``cuda`` and raises without a card, as the
serving engine does; the CPU runs only when asked for.  Each step's
batch is ``SyntheticLM.batch_at(step)`` (a pure function of the step,
so a restart needs no data state), copied to the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..kernels.dispatch import resolve_device
from ..models.model import build_model
from ..optim.tree import map_parts
from .checkpoint import CheckpointManager
from .fault import FaultConfig, FaultMonitor
from .train_step import make_train_step, state_from_tree


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    global_batch: int = 8
    seq_len: int = 64
    peak_lr: float = 1e-3
    warmup: int = 20
    compress_grads: bool = False
    dispatch: str = "spec"


def train(cfg: ArchConfig, tcfg: TrainerConfig,
          log: Callable[[str], None] = print,
          device=None) -> Dict[str, Any]:
    device = resolve_device(device, "train")
    model = build_model(cfg, dispatch=tcfg.dispatch)
    init_state, train_step, opt_name = make_train_step(
        model, compress=tcfg.compress_grads,
        peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.steps)

    mgr = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state = state_from_tree(mgr.restore(shard_fn=lambda t: map_parts(
            lambda path, group, x: x.to(device) if torch.is_tensor(x)
            else x, t)), opt_name)
        start_step = int(state.step)
        log(f"[trainer] restored step {start_step} from {tcfg.ckpt_dir}")
    else:
        state = init_state(torch.Generator(device=device).manual_seed(0),
                           device)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=tcfg.seq_len,
                                  global_batch=tcfg.global_batch))
    monitor = FaultMonitor(["host0"], FaultConfig())
    losses = []
    t_start = time.perf_counter()
    for step in range(start_step, tcfg.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        monitor.heartbeat("host0")
        monitor.report_step("host0", time.perf_counter() - t0)
        losses.append(loss)
        if step % tcfg.log_every == 0:
            log(f"[trainer] step {step:5d} loss {loss:.4f}")
        if mgr and step and step % tcfg.ckpt_every == 0:
            mgr.save_async(step, state)
    if mgr:
        mgr.save(tcfg.steps, state)
    wall = time.perf_counter() - t_start
    return {"final_loss": losses[-1] if losses else None,
            "losses": losses, "optimizer": opt_name,
            "wall_s": wall, "state": state}
