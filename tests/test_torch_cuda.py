"""The port on a CUDA card: the CUDA kernels against their plain versions,
and the torch target on the card against the same run on the CPU.

Every test needs a CUDA device and skips without one (``cuda`` marker).
The file imports neither jax nor ``repro``, so it runs where only the
port is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import codegen
from repro_torch.bench_irregular import ALL
from repro_torch.core import pipeline
from repro_torch.kernels import ref
from repro_torch.kernels.spec_gather import spec_gather
from repro_torch.kernels.spec_scatter import spec_scatter_add

pytestmark = pytest.mark.cuda

#: float32 scatter-add: atomics sum duplicates in a run-dependent order
#: (tests/test_kernels.py's float32 scatter tolerance)
SCATTER_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rows, d, n, dtype, seed=7):
    rng = np.random.default_rng(seed)
    # -3..-1 poison, in range, and up to 4 past the last row (clip)
    idx = rng.integers(-3, rows + 4, n).astype(np.int32)
    if dtype == np.int32:
        tab = rng.integers(-2 ** 31, 2 ** 31, (rows, d),
                           dtype=np.int64).astype(np.int32)
        val = rng.integers(-2 ** 31, 2 ** 31, (n, d),
                           dtype=np.int64).astype(np.int32)
    else:
        tab = rng.normal(size=(rows, d)).astype(np.float32)
        val = rng.normal(size=(n, d)).astype(np.float32)
    return tab, idx, val


@pytest.mark.parametrize("rows,d,n", [(1, 1, 1), (8, 1, 37), (61, 7, 100),
                                      (16, 128, 24), (64, 3, 0),
                                      (65536, 1, 512), (40, 1, 4099)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_cuda_kernels_match_plain(cuda, rows, d, n, dtype):
    t, i, v = (torch.from_numpy(x).to(cuda)
               for x in _inputs(rows, d, n, dtype))
    g0, s0 = spec_gather.launches, spec_scatter_add.launches
    got = spec_gather(t, i)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.spec_gather(t, i))
    got = spec_scatter_add(t.clone(), i, v)
    torch.cuda.synchronize()
    want = ref.spec_scatter_add(t.clone(), i, v)
    if dtype == np.int32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=SCATTER_ATOL)
    launched = int(n > 0)
    assert (spec_gather.launches - g0, spec_scatter_add.launches - s0) == \
        (launched, launched)


@pytest.mark.parametrize("cu_mode", ["vector", "state-machine"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_cuda_run_matches_cpu_and_counts_launches(cuda, name, cu_mode):
    case = ALL[name]()
    comp = pipeline.compile_spec(case.fn, case.decoupled)
    runs = {}
    for device in ("cpu", "cuda"):
        mem = {k: v.copy() for k, v in case.memory.items()}
        g0, s0 = spec_gather.launches, spec_scatter_add.launches
        r = codegen.run(comp, mem, case.params, target="torch",
                        device=device, cu_mode=cu_mode)
        runs[device] = (r, mem, (spec_gather.launches - g0,
                                 spec_scatter_add.launches - s0))
    (rc, mc, lc), (rp, mp, _) = runs["cuda"], runs["cpu"]
    for k in mp:
        assert np.array_equal(mp[k], mc[k]), k
    assert rc.target_used == "torch" and rc.cu_mode == cu_mode
    assert rc.stats == rp.stats
    assert lc == (rc.stats["gather_calls"], rc.stats["scatter_calls"])
    assert lc[0] > 0 and lc[1] > 0
