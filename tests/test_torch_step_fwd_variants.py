"""``repro_torch.launch.step_fwd_variants``: each alternative it times is
made from the shipped step forwards' sources, each replacement matching
once, so the script builds what it says as the sources move; its SASS
counter finds a kernel's innermost loops whether a branch names its
target by label or by address.  Building, counting on real SASS and
timing need a card; here the sources, the counter on a written listing
and the refusal without a card are checked."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.launch import step_fwd_variants as sv
from repro_torch.launch import variants

CASES = [(lib, name) for lib, vs in sv.VARIANTS.items() for name in vs]


@pytest.mark.parametrize("lib,name", CASES)
def test_each_variant_builds_from_the_shipped_source(lib, name):
    """Every replacement matches once, and only the first variant of each
    library is the shipped source itself."""
    text = variants.source(lib, sv.VARIANTS[lib][name])
    shipped = (build.SRC_DIR / f"{lib}.cu").read_text()
    assert (text == shipped) == (name == next(iter(sv.VARIANTS[lib])))


@pytest.mark.parametrize("lib", sorted(sv.KERNELS))
def test_the_counted_kernel_ships(lib):
    """The kernel the counter looks for is in the shipped source."""
    fragment = sv.KERNELS[lib][0]
    assert f"\n{fragment}(" in (build.SRC_DIR / f"{lib}.cu").read_text()


#: a listing in cuobjdump's layout: an outer loop (to an address) around
#: an inner one (to a label) of two steps, each one MUFU.EX2
LISTING = """\
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   FMUL R2, R2, R3 ;        /* 0x0 */
.L_x_3:
        /*0020*/                   MUFU.EX2 R4, R2 ;        /* 0x0 */
        /*0030*/                   FFMA.SAT R5, R4, R4, 0.5 ;  /* 0x0 */
        /*0040*/                   MUFU.EX2 R6, R5 ;        /* 0x0 */
        /*0050*/              @!P0 BRA `(.L_x_3) ;          /* 0x0 */
        /*0060*/                   FADD R7, R7, R6 ;        /* 0x0 */
        /*0070*/               @P1 BRA 0x10 ;               /* 0x0 */
        /*0080*/                   EXIT ;                   /* 0x0 */
"""


def test_inner_loops_reads_labels_and_addresses():
    loops = sv.inner_loops(LISTING.splitlines())
    assert len(loops) == 1  # the outer loop holds the inner one
    (loop,) = loops
    assert loop["instructions"] == 4
    assert loop["ops"]["MUFU.EX2"] == 2 and loop["ops"]["FFMA.SAT"] == 1
    assert loop["ops"]["BRA"] == 1


def test_per_element_step_counts_the_marked_steps(monkeypatch):
    name = "_ZN12_GLOBAL__N_116mamba_fwd_kernelIfLi16EEEvPKT_"
    monkeypatch.setattr(sv, "sass_functions",
                        lambda path: {name: LISTING.splitlines(),
                                      "_Z13colsum_kernelPKfPfll": []})
    monkeypatch.setitem(sv.KERNELS, "mamba_scan",
                        ("mamba_fwd_kernel", "MUFU.EX2", 1, 16))
    got = sv.per_element_step("unused", "mamba_scan")
    assert set(got) == {"float32"}
    assert got["float32"]["steps_an_iteration"] == 2
    assert got["float32"]["per_element_step"] == 4 / (2 * 16)


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        sv.main([])
