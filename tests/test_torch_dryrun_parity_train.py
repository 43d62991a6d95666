"""The training cells of ``tests/test_torch_dryrun_parity.py``: each
package's dry-run CLI on a train_4k cell, per-device collective bytes
held to the same two checks (the port's total within 2x of the
reference's either way; its all-gathers at most twice the reference's
plus 5% of the reference's total).  Phi-4-mini drives the dense train
step with FSDP gathers of the weights and the vocabulary-parallel loss;
RWKV-6-7B the SSM train step, whose time scans the dry run counts a step
at a time and multiplies by the trip count.
"""
from __future__ import annotations

import pytest
from test_torch_dryrun_parity import check_collectives, dryrun_pair

CELLS = [("phi4_mini_3_8b", "train_4k"), ("rwkv6_7b", "train_4k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_collectives_match_reference(arch, shape, tmp_path):
    ref, port = dryrun_pair(arch, shape, tmp_path)
    assert port["n_devices"] == ref["n_devices"] == 256
    check_collectives(ref, port)
