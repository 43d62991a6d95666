"""``repro_torch.launch.rwkv6_staging``: the layouts it times are made
from the shipped RWKV-6 chunked forward's source, each replacement
matching once, so the script builds what it says as the source moves.
Building and timing need a card; here only the sources and the refusal
without one are checked."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.launch import rwkv6_staging as st


def _shipped() -> str:
    return (build.SRC_DIR / f"{st.LIB}.cu").read_text()


def test_one_buffer_is_the_shipped_source():
    assert st._source(st.VARIANTS["one buffer"]) == _shipped()
    assert "T rkw[3][kC][kP];" in _shipped()


@pytest.mark.parametrize("i", range(len(st.VARIANTS["two buffers"])))
def test_two_buffer_replacements_each_match_once(i):
    old, new = st.VARIANTS["two buffers"][i]
    assert _shipped().count(old) == 1
    assert old != new


def test_two_buffers_stage_the_next_chunk_beside_v():
    text = st._source(st.VARIANTS["two buffers"])
    assert "T rkw[2][3][kC][kP];" in text
    assert "load_rkw(c + 1, st ^ 1);\n      load_v(c + 1, st ^ 1);" in text
    assert "load_rkw(c + 1);" not in text
    assert text.count("sm.rkw[st][") == 3


def test_source_refuses_a_replacement_that_does_not_match():
    with pytest.raises(RuntimeError, match="found 0 times"):
        st._source([("no such line in the kernel", "")])


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        st.main([])
