"""Deterministic synthetic LM data pipeline.

A copy of the JAX package's ``data/pipeline.py`` (numpy only, so
``batch_at`` gives the reference's batches bit for bit).  Production
posture: per-host sharded, seekable (exact restart from a step
counter — the checkpointing contract), with background prefetch.  Tokens are
a seeded PRNG stream passed through a light Zipf-ish map so losses move.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Seekable: ``batch_at(step)`` is a pure function of (config, step) —
    restart-safe without data-state checkpoints."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.per_host = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4099 + cfg.host_id)
        u = rng.random((self.per_host, cfg.seq_len + 1))
        toks = np.minimum((u ** 3.0) * cfg.vocab, cfg.vocab - 1).astype(
            np.int32)
        # short deterministic bigram structure => learnable signal
        toks[:, 1::2] = (toks[:, 0:-1:2] * 31 + 7) % cfg.vocab
        return {"tokens": toks[:, :cfg.seq_len]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-N FIFO — the data pipeline's own
    access/execute decoupling)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
