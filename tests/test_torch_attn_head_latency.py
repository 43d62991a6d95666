"""``repro_torch.launch.attn_head_latency``: the load-only kernel it times
is made from the shipped head route's source, each replacement matching
once, so the script builds what it says as the source moves.  Building
and timing need a card; here only the sources and the refusal without
one are checked."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.launch import attn_head_latency as hl
from repro_torch.launch import variants


def _shipped() -> str:
    return (build.SRC_DIR / f"{hl.LIB}.cu").read_text()


def test_whole_is_the_shipped_source():
    assert variants.source(hl.LIB, hl.VARIANTS["whole"]) == _shipped()


@pytest.mark.parametrize("i", range(len(hl.VARIANTS["load only"])))
def test_load_only_replacements_each_match_once(i):
    old, new = hl.VARIANTS["load only"][i]
    assert _shipped().count(old) == 1
    assert new == old + hl._RETURN


def test_load_only_returns_after_every_wait():
    """Each of the four bodies (bf16 and float32, forward and backward)
    returns right after its mbarrier wait, and nowhere else."""
    text = variants.source(hl.LIB, hl.VARIANTS["load only"])
    assert _shipped().count(hl._WAIT) == 4
    assert text.count(hl._WAIT + hl._RETURN) == 4
    assert text.count(hl._RETURN) == 4


def test_source_refuses_a_replacement_that_does_not_match():
    with pytest.raises(RuntimeError, match="found 0 times"):
        variants.source(hl.LIB, [("no such line in the kernel", "")])


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        hl.main([])
