"""The traffic generator: the same seed sends the same requests; lengths
are drawn independently within the mix's bounds; an open loop offers the
window ``round(rate * seconds)`` requests at times drawn from the seed."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.traffic import Traffic, load_mix

MIXES = Path(__file__).resolve().parent / "traffic"
NAMES = sorted(p.stem for p in MIXES.glob("*.json"))
SEEDS = (0, 7, 2**31 + 5, 2**40 + 11)


@pytest.mark.parametrize("name", NAMES)
def test_mix_files_load(name):
    mix = load_mix(MIXES / f"{name}.json")
    t = Traffic(mix, 1, 1000, 40.0)
    assert t.longest_prompt() == mix["prompt"]["hi"]
    assert t.longest_output() == mix["output"]["hi"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_requests(name, seed):
    mix = load_mix(MIXES / f"{name}.json")
    a = Traffic(mix, seed, 163840, 40.0)
    b = Traffic(mix, seed, 163840, 40.0)
    for i in (0, 1, 57, 300):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_new, ra.offset_s) == (rb.max_new, rb.offset_s)
        assert ra.prompt.dtype == np.int32
        assert 1 <= ra.prompt.min() and ra.prompt.max() < 163840


@pytest.mark.parametrize("name", NAMES)
def test_lengths_fill_the_bounds_and_change_with_the_seed(name):
    mix = load_mix(MIXES / f"{name}.json")
    draws = {}
    for seed in SEEDS:
        t = Traffic(mix, seed, 1000, 40.0)
        reqs = [t.request(i) for i in range(400)]
        plens = np.array([len(r.prompt) for r in reqs])
        outs = np.array([r.max_new for r in reqs])
        for v, spec in ((plens, mix["prompt"]), (outs, mix["output"])):
            assert spec["lo"] <= v.min() and v.max() <= spec["hi"]
            # log-uniform: the median near the geometric mean, and both
            # tails reached
            mid = np.sqrt(spec["lo"] * (spec["hi"] + 1))
            assert 0.8 < np.median(v) / mid < 1.25
            span = spec["hi"] - spec["lo"]
            assert v.min() < spec["lo"] + 0.05 * span
            assert v.max() > spec["hi"] - 0.05 * span
        draws[seed] = (tuple(plens[:32]), tuple(outs[:32]))
    assert len(set(draws.values())) == len(SEEDS)


@pytest.mark.parametrize("seconds", (12.0, 40.0, 51.0))
@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_offers_the_rate_in_a_poisson_stream(seed, seconds):
    mix = json.loads((MIXES / "chat-open.json").read_text())
    t = Traffic(mix, seed, 1000, seconds)
    n = int(round(mix["rate"] * seconds))
    due = [t.offset_s(i) for i in range(n + 5)]
    assert all(a <= b for a, b in zip(due, due[1:]))
    assert sum(1 for x in due if x < seconds) == n
    assert all(0 <= x < seconds for x in due[:n])
    # bursts come: a second of the window holds a varying count
    counts = np.bincount(np.floor(due[:n]).astype(int),
                         minlength=int(seconds))
    assert counts.max() >= mix["rate"] + 2
    assert counts.min() <= mix["rate"] - 2


def test_open_loop_times_change_with_the_seed():
    mix = json.loads((MIXES / "chat-open.json").read_text())
    firsts = {Traffic(mix, s, 1000, 40.0).offset_s(0) for s in SEEDS}
    assert len(firsts) == len(SEEDS)


def test_bad_mix_is_refused(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"loop": "sometimes"}))
    with pytest.raises(ValueError):
        load_mix(p)
