"""The port's kernel layer (repro_torch.kernels) against the JAX reference.

* the plain PyTorch versions against ``repro.kernels.ref`` on the same
  seeded numpy inputs, poisoned ``-1`` rows and indices past the last row
  included — int32 bitwise, float32 at ``tests/test_kernels.py``'s
  tolerances;
* the plain versions against the Pallas kernels in interpret mode, on
  in-range indices (the Pallas kernels do not clamp above);
* the wrappers' dispatch (CPU tensors take the plain version, nothing is
  launched), argument checks and fault sites, like for like with the
  reference wrappers under the same armed plan.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.spec_gather import spec_gather as jgather
from repro.kernels.spec_scatter import spec_scatter_add as jscatter
from repro.resilience import faults as jfaults
from repro_torch.kernels import ref
from repro_torch.kernels.spec_gather import spec_gather
from repro_torch.kernels.spec_scatter import spec_scatter_add
from repro_torch.resilience import faults

#: tests/test_kernels.py's float32 tolerances (gather is a copy, scatter
#: sums in another order)
GATHER_ATOL, SCATTER_ATOL = 1e-6, 1e-4

SHAPES = [(1, 1, 1), (8, 1, 37), (61, 7, 100), (16, 128, 24), (5, 128, 17),
          (64, 3, 0)]


def _inputs(rows, d, n, dtype, lo, hi, seed=7):
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, hi, n).astype(np.int32)
    if dtype == np.int32:
        tab = rng.integers(-2 ** 31, 2 ** 31, (rows, d),
                           dtype=np.int64).astype(np.int32)
        val = rng.integers(-2 ** 31, 2 ** 31, (n, d),
                           dtype=np.int64).astype(np.int32)
    else:
        tab = rng.normal(size=(rows, d)).astype(np.float32)
        val = rng.normal(size=(n, d)).astype(np.float32)
    return tab, idx, val


def _check(got, want, dtype, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol)


# ---------------------------------------------------------------------------
# plain versions vs repro.kernels.ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d,n", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_plain_gather_matches_reference_ref(rows, d, n, dtype):
    # -3..-1 poison, in range, and up to 4 past the last row (clip)
    tab, idx, _ = _inputs(rows, d, n, dtype, -3, rows + 4)
    got = ref.spec_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    _check(got, jref.spec_gather(jnp.asarray(tab), jnp.asarray(idx)), dtype,
           GATHER_ATOL)


@pytest.mark.parametrize("rows,d,n", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_plain_scatter_matches_reference_ref(rows, d, n, dtype):
    tab, idx, val = _inputs(rows, d, n, dtype, -3, rows + 4)
    t = torch.from_numpy(tab.copy())
    got = ref.spec_scatter_add(t, torch.from_numpy(idx),
                               torch.from_numpy(val))
    assert got is t  # in place
    want = jref.spec_scatter_add(jnp.asarray(tab), jnp.asarray(idx),
                                 jnp.asarray(val))
    _check(got, want, dtype, SCATTER_ATOL)


def test_plain_scatter_duplicates_add_and_poison_never_commits():
    tab = np.arange(12, dtype=np.int32).reshape(6, 2)
    idx = np.array([2, 2, -1, 2, 9, 0, -1], np.int32)
    val = np.full((7, 2), 5, np.int32)
    got = ref.spec_scatter_add(torch.from_numpy(tab.copy()),
                               torch.from_numpy(idx), torch.from_numpy(val))
    want = tab.copy()
    want[2] += 15   # three duplicates add up
    want[5] += 5    # 9 clips to the last row
    want[0] += 5
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d,n", [(8, 1, 8), (32, 128, 16), (5, 128, 17)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_plain_matches_pallas_interpret(rows, d, n, dtype):
    # in-range and poisoned indices only: Pallas clamps at 0, not above
    tab, idx, val = _inputs(rows, d, n, dtype, -1, rows, seed=rows + n)
    jt, ji, jv = jnp.asarray(tab), jnp.asarray(idx), jnp.asarray(val)
    bd = min(d, 128)
    _check(ref.spec_gather(torch.from_numpy(tab), torch.from_numpy(idx)),
           jgather(jt, ji, block_d=bd, interpret=True), dtype, GATHER_ATOL)
    _check(ref.spec_scatter_add(torch.from_numpy(tab.copy()),
                                torch.from_numpy(idx),
                                torch.from_numpy(val)),
           jscatter(jt, ji, jv, block_d=bd, interpret=True), dtype,
           SCATTER_ATOL)


# ---------------------------------------------------------------------------
# wrappers: dispatch, checks, fault sites
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    tab, idx, val = _inputs(16, 3, 40, np.int32, -2, 20)
    g0, s0 = spec_gather.launches, spec_scatter_add.launches
    t = torch.from_numpy(tab.copy())
    got = spec_gather(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(
        got.numpy(), ref.spec_gather(t, torch.from_numpy(idx)).numpy())
    out = spec_scatter_add(t, torch.from_numpy(idx), torch.from_numpy(val))
    assert out is t
    assert (spec_gather.launches, spec_scatter_add.launches) == (g0, s0)


@pytest.mark.parametrize("bad", ["table-int64", "table-f64", "idx-int64",
                                 "idx-2d", "table-1d", "values-dtype",
                                 "values-shape", "meta-device",
                                 "mixed-device", "empty-table"])
def test_wrapper_argument_checks(bad):
    t = torch.zeros((4, 2), dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int32)
    v = torch.zeros((3, 2), dtype=torch.int32)
    if bad == "table-int64":
        t = t.long()
    elif bad == "table-f64":
        t = t.double()
    elif bad == "idx-int64":
        i = i.long()
    elif bad == "idx-2d":
        i = i[:, None]
    elif bad == "table-1d":
        t = t[:, 0].contiguous()
    elif bad == "values-dtype":
        v = v.float()
    elif bad == "values-shape":
        v = v[:2]
    elif bad == "meta-device":
        t, i, v = (x.to("meta") for x in (t, i, v))
    elif bad == "mixed-device":
        i = i.to("meta")
    elif bad == "empty-table":
        t = t[:0]
    with pytest.raises((TypeError, ValueError)):
        if bad.startswith("values"):
            spec_scatter_add(t, i, v)
        else:
            spec_gather(t, i)
            spec_scatter_add(t, i, v)


@pytest.mark.parametrize("site", ["kernels.gather.allpoison",
                                  "kernels.gather.rows",
                                  "kernels.scatter.raise",
                                  "kernels.scatter.allpoison"])
def test_fault_sites_fire_like_the_reference(site):
    """Each site, armed alone at rate 1, does to the port's wrappers what
    it does to the reference wrappers (interpret mode)."""
    tab, idx, val = _inputs(8, 1, 8, np.int32, -1, 8)
    plan_args = ({site: 1.0},)
    results = {}
    with jfaults.armed(jfaults.FaultPlan(*plan_args, seed=1)):
        try:
            jt = jnp.asarray(tab)
            results["jax"] = (
                np.asarray(jgather(jt, jnp.asarray(idx), block_d=1,
                                   interpret=True)),
                np.asarray(jscatter(jt, jnp.asarray(idx), jnp.asarray(val),
                                    block_d=1, interpret=True)))
        except jfaults.InjectedFault as e:
            results["jax"] = e.site
    with faults.armed(faults.FaultPlan(*plan_args, seed=1)):
        try:
            results["torch"] = (
                spec_gather(torch.from_numpy(tab), torch.from_numpy(idx))
                .numpy(),
                spec_scatter_add(torch.from_numpy(tab.copy()),
                                 torch.from_numpy(idx),
                                 torch.from_numpy(val)).numpy())
        except faults.InjectedFault as e:
            results["torch"] = e.site
    assert not faults.ACTIVE and not jfaults.ACTIVE
    if site == "kernels.scatter.raise":
        assert results["jax"] == results["torch"] == site
        return
    for got, want in zip(results["torch"], results["jax"]):
        np.testing.assert_array_equal(got, want)
