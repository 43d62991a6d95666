"""bfloat16 in the speculative kernels' tensor route (the MoE dispatch's
dtype), on the CPU: the wrappers' plain versions against the JAX
reference on the same seeded bf16 inputs.

* gather: bitwise against ``repro.kernels.ref`` (a poisoned row is zeros,
  an index past the table clips) and against the Pallas kernel in
  interpret mode on in-range indices;
* scatter with unique destinations (the MoE buffer fill): bitwise;
* scatter with duplicates: each element within
  ``repro_torch.kernels.ref.bf16_sum_bound`` of the float32 sum, a bound
  the reference's bf16 scatter meets too.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.spec_gather import spec_gather as jgather
from repro.kernels.spec_scatter import spec_scatter_add as jscatter
from repro_torch.kernels import ref
from repro_torch.kernels.dispatch import DTYPES
from repro_torch.kernels.spec_gather import spec_gather, spec_gather_staged
from repro_torch.kernels.spec_scatter import (spec_scatter_add,
                                              spec_scatter_add_staged)
from repro_torch.kernels.staging import Ring


def _bf16(a: np.ndarray):
    """The same bf16 values for both packages: (torch, jax)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    j = jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return t, j


def _bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _inputs(rows, d, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, hi, n).astype(np.int32)
    tab = rng.standard_normal((rows, d)).astype(np.float32)
    val = rng.standard_normal((n, d)).astype(np.float32)
    return tab, idx, val


SHAPES = [(1, 1, 1), (8, 7, 37), (61, 8, 100), (16, 128, 24), (40, 33, 0),
          (384, 112, 64)]


@pytest.mark.parametrize("rows,d,n", SHAPES)
def test_gather_bf16_matches_reference_bitwise(rows, d, n):
    # -3..-1 poison, in range, and up to 4 past the last row (clip)
    tab, idx, _ = _inputs(rows, d, n, -3, rows + 4, seed=rows + d)
    t, j = _bf16(tab)
    got = spec_gather(t, torch.from_numpy(idx))
    want = jref.spec_gather(j, jnp.asarray(idx))
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got[torch.from_numpy(idx) < 0].any()


@pytest.mark.parametrize("rows,d,n", [(8, 8, 8), (32, 128, 16)])
def test_gather_bf16_matches_pallas_interpret(rows, d, n):
    # in-range and poisoned indices only: Pallas clamps at 0, not above
    tab, idx, _ = _inputs(rows, d, n, -1, rows, seed=n)
    t, j = _bf16(tab)
    got = spec_gather(t, torch.from_numpy(idx))
    want = jgather(j, jnp.asarray(idx), block_d=d, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("rows,d,n", [(8, 7, 6), (61, 8, 40), (384, 112, 64),
                                      (40, 33, 0)])
def test_scatter_bf16_unique_slots_bitwise(rows, d, n):
    """The MoE fill: a zero buffer, each live slot hit once, the rest of
    the requests poisoned; 0 + v = v bit for bit, poisoned rows dropped."""
    rng = np.random.default_rng(rows)
    idx = rng.permutation(rows)[:n].astype(np.int32)
    idx[::3] = -1
    val = rng.standard_normal((n, d)).astype(np.float32)
    tv, jv = _bf16(val)
    table = torch.zeros((rows, d), dtype=torch.bfloat16)
    got = spec_scatter_add(table, torch.from_numpy(idx), tv)
    assert got is table
    want = jref.spec_scatter_add(jnp.zeros((rows, d), jnp.bfloat16),
                                 jnp.asarray(idx), jv)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    live = idx >= 0
    np.testing.assert_array_equal(_bits(got[torch.from_numpy(idx[live])
                                            .long()]), _bits(tv[live]))


@pytest.mark.parametrize("rows,d,n", [(3, 7, 30), (5, 8, 60),
                                      (61, 128, 300)])
def test_scatter_bf16_duplicates_within_bound(rows, d, n):
    """Duplicates add up: each element within bf16_sum_bound of the
    float32 sum, for the port's plain version and the reference's."""
    tab, idx, val = _inputs(rows, d, n, -1, rows + 2, seed=n)
    tt, jt = _bf16(tab)
    tv, jv = _bf16(val)
    ti = torch.from_numpy(idx)
    want = ref.spec_scatter_add(tt.float(), ti, tv.float())
    bound = ref.bf16_sum_bound(tt, ti, tv)
    got = spec_scatter_add(tt.clone(), ti, tv)
    assert ((got.float() - want).abs() <= bound).all()
    jgot = torch.from_numpy(np.asarray(
        jref.spec_scatter_add(jt, jnp.asarray(idx), jv)).astype(np.float32))
    assert ((jgot - want).abs() <= bound).all()


def test_scatter_bf16_matches_pallas_interpret_unique():
    rng = np.random.default_rng(9)
    idx = rng.permutation(32)[:16].astype(np.int32)
    idx[::4] = -1
    tv, jv = _bf16(rng.standard_normal((16, 128)).astype(np.float32))
    got = spec_scatter_add(torch.zeros((32, 128), dtype=torch.bfloat16),
                           torch.from_numpy(idx), tv)
    want = jscatter(jnp.zeros((32, 128), jnp.bfloat16), jnp.asarray(idx),
                    jv, block_d=128, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bf16_counters_and_routes():
    """bf16 is admitted by the tensor route; each wrapper counts launches
    by C entry, a bf16 one among them; CPU calls launch nothing; the
    staged route stays int32 only."""
    assert torch.bfloat16 in DTYPES
    assert "spec_gather_bf16" in spec_gather.entry_launches
    assert "spec_scatter_add_bf16" in spec_scatter_add.entry_launches
    before = (dict(spec_gather.entry_launches),
              dict(spec_scatter_add.entry_launches))
    t = torch.zeros((4, 2), dtype=torch.bfloat16)
    i = torch.tensor([0, -1, 3], dtype=torch.int32)
    spec_scatter_add(t, i, torch.ones((3, 2), dtype=torch.bfloat16))
    spec_gather(t, i)
    assert (spec_gather.entry_launches,
            spec_scatter_add.entry_launches) == before
    ring = Ring(torch.device("cpu"), slots=1)
    slot = ring.acquire(2)
    with pytest.raises(TypeError):
        spec_gather_staged(t[:, :1].contiguous(), slot, 2)
    with pytest.raises(TypeError):
        spec_scatter_add_staged(t[:, :1].contiguous(), slot, 2)
    with pytest.raises(TypeError):
        spec_scatter_add(t, i, torch.ones((3, 2)))
