"""The one traffic generator: a mix file of parameters, a seed, requests.

A mix (``traffic/<name>.json``) says how requests arrive and how long
they are:

* ``loop``: ``"closed"`` (``clients`` callers, each sending its next
  request when the last one is answered) or ``"open"`` (independent
  users arriving at ``rate`` a second, sent on schedule).
* ``slots``: the engine's batch, the requests a wave may hold.
* ``prompt`` / ``output``: ``{"dist": "loguniform" | "uniform", "lo",
  "hi"}`` token counts, both ends included, drawn independently for
  every request.
* ``check``: how many waves the reference follows once the window has
  closed, and how many requests of each wave it judges.

Open loop: the arrivals of a window of ``seconds`` are a Poisson process
of ``rate`` conditioned on its count, ``round(rate * seconds)`` arrival
times drawn uniform over the window and sorted.  Bursts come as they
come in a Poisson stream; every seed offers the window the same number
of requests, at other times.

Request ``i`` of a seed is the same in every run: its lengths and its
prompt ids (uniform in ``[1, vocab)``) come from a generator seeded with
``(seed, i)``, the arrival times from one seeded with the seed alone.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

#: keys of a mix file, and the loops it may ask for
LOOPS = ("closed", "open")


def load_mix(path) -> Dict:
    """Read and check one mix file."""
    mix = json.loads(Path(path).read_text())
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"{path}: loop must be one of {LOOPS}")
    for key in ("prompt", "output"):
        spec = mix[key]
        if spec["dist"] not in ("loguniform", "uniform") or not (
                1 <= spec["lo"] <= spec["hi"]):
            raise ValueError(f"{path}: bad {key} {spec}")
    if mix["loop"] == "closed" and mix["clients"] < 1:
        raise ValueError(f"{path}: a closed loop needs clients")
    if mix["loop"] == "open" and not mix["rate"] > 0:
        raise ValueError(f"{path}: an open loop needs a rate")
    return mix


def _quantile(spec: Dict, q: float) -> int:
    """The length at quantile ``q`` in [0, 1) of a length distribution."""
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "loguniform":
        v = lo * math.exp(q * math.log((hi + 1) / lo))
    else:
        v = lo + q * (hi + 1 - lo)
    return int(min(hi, max(lo, math.floor(v))))


def _seed_words(seed: int) -> List[int]:
    """A seed of any size as 32-bit words for numpy's SeedSequence."""
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


@dataclass
class Draw:
    """One request as the traffic sends it."""
    index: int
    prompt: np.ndarray      # int32 token ids
    max_new: int
    offset_s: float         # open loop: due this long after the window opens


class Traffic:
    """The requests of one mix under one seed, for a window of
    ``seconds``."""

    def __init__(self, mix: Dict, seed: int, vocab: int, seconds: float):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        self.seconds = float(seconds)
        self._arrivals = None

    def arrivals(self) -> np.ndarray:
        """Open loop: the due times inside the window, sorted."""
        if self._arrivals is None:
            n = int(round(self.mix["rate"] * self.seconds))
            rng = np.random.default_rng(_seed_words(self.seed) + [1])
            self._arrivals = np.sort(rng.random(n) * self.seconds)
        return self._arrivals

    def offset_s(self, i: int) -> float:
        """Open loop: when request ``i`` is due, after the window opens;
        those past the window's count are due after it closes."""
        t = self.arrivals()
        if i < len(t):
            return float(t[i])
        return self.seconds + (i - len(t) + 1) / self.mix["rate"]

    def request(self, i: int) -> Draw:
        """Request ``i``."""
        rng = np.random.default_rng(_seed_words(self.seed) + [2, i])
        qp, qo = rng.random(2)
        plen = _quantile(self.mix["prompt"], qp)
        max_new = _quantile(self.mix["output"], qo)
        prompt = rng.integers(1, self.vocab, plen).astype(np.int32)
        offset = self.offset_s(i) if self.mix["loop"] == "open" else 0.0
        return Draw(i, prompt, max_new, offset)

    def longest_prompt(self) -> int:
        """The longest prompt any request of this mix may have."""
        return self.mix["prompt"]["hi"]

    def longest_output(self) -> int:
        """The longest output any request of this mix may ask for."""
        return self.mix["output"]["hi"]
