"""On the card: the smoke cells through the CUDA kernels against the
plain reference, traced."""
import time

import pytest
import torch

from bench import harness
from bench.testing import smoke_root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("smoke.moe-closed", "smoke.moe-open"))
def test_smoke_cell_on_the_card(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = smoke_root(tmp_path)
    result = harness.run_cell(root, cell, 2**31 + 3, 1.0, True,
                              torch.device("cuda"), time.perf_counter(),
                              log=lambda m: None)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
