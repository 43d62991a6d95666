"""``repro_torch.launch.step_bwd_units``: each alternative it times is made
from the shipped step backward pairs' sources, each replacement matching
once, so the script builds what it says as the sources move; its
workspaces are the ones the wrappers allocate.  Building and timing need
a card; here only the sources, the workspaces and the refusal without
one are checked."""
import pytest
import torch

from repro_torch.kernels import build, scan
from repro_torch.launch import step_bwd_units as su
from repro_torch.launch import variants

CASES = [(lib, name) for lib, vs in su.VARIANTS.items() for name in vs]


def _shipped(lib) -> str:
    return (build.SRC_DIR / f"{lib}.cu").read_text()


@pytest.mark.parametrize("lib,name", CASES)
def test_each_variant_builds_from_the_shipped_source(lib, name):
    """Every replacement matches once, and only the first variant of
    each library is the shipped source itself."""
    unit, subs = su.VARIANTS[lib][name]
    text = variants.source(lib, su._subs(lib, subs))
    first = name == next(iter(su.VARIANTS[lib]))
    assert (text == _shipped(lib)) == first


@pytest.mark.parametrize("lib", sorted(su.VARIANTS))
def test_the_shipped_variant_is_the_wrappers_unit(lib):
    """The first variant's unit is the one the sources ship and the
    wrappers size their workspace by."""
    unit, _ = next(iter(su.VARIANTS[lib].values()))
    want = (scan.RWKV6_STEP_UNIT if lib == "rwkv6_scan"
            else scan.MAMBA_STEP_UNIT)
    assert unit == want
    text = _shipped(lib)
    assert (f"kStepUnit = {unit};" if lib == "rwkv6_scan"
            else f"kStepUnitM = {unit};") in text


def test_the_kept_stretch_is_found_once():
    """The Mamba variant that recomputes the stretch replaces exactly the
    shipped pass 2's walk."""
    text = _shipped("mamba_scan")
    assert text.count(su._M_KEEP_FROM) == 1
    kept = su._m_keep()
    assert text.count(kept) == 1
    assert "ep[kSub][kQ]" in kept and "ep[" not in su._M_RECOMPUTE


@pytest.mark.parametrize("unit", [16, 32, 64])
@pytest.mark.parametrize("lib", sorted(su.VARIANTS))
def test_workspace_is_the_wrappers(lib, unit):
    """What the script allocates for a unit is what the wrappers'
    docstrings give for theirs (boundaries and partial sums, float32) at
    the script's shape."""
    n_u = -(-su.T // unit)
    if lib == "rwkv6_scan":
        h = su.WIDTH[lib] // su.HD
        want = (2 * su.B * h * su.HD ** 2 + su.B * h * su.HD) * n_u * 4
    else:
        d = su.WIDTH[lib]
        want = (3 * su.B * n_u * d * su.N
                + -(-d // scan.MAMBA_BWD_BLOCK) * su.B * su.T
                * (2 * su.N + 1)) * 4
    assert su.workspace_bytes(lib, unit) == want


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        su.main([])
