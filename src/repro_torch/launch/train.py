"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi4-mini-3.8b --smoke --steps 100 --ckpt /tmp/ckpt \\
        --device cpu

The counterpart of the JAX package's ``launch/train.py``, with the same
flags plus ``--device`` (``cuda`` by default; without a card that raises
instead of running on the CPU).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ASSIGNED, get, smoke
from repro_torch.train.trainer import TrainerConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {ASSIGNED}")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dispatch", default="spec", choices=("spec", "dense"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                         global_batch=args.batch, seq_len=args.seq,
                         peak_lr=args.lr, compress_grads=args.compress_grads,
                         dispatch=args.dispatch)
    out = train(cfg, tcfg, device=args.device)
    print(f"done: loss {out['losses'][0]:.4f} -> {out['final_loss']:.4f} "
          f"({out['optimizer']}, {out['wall_s']:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
