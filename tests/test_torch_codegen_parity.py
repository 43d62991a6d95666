"""Second half of the port's codegen parity matrix (see
``tests/test_torch_codegen.py``, which holds the helpers and the other
workloads): the same three checks per (workload, compiler, CU mode) leg,
one shared reference run per leg."""
import pytest

from test_torch_codegen import check_fields, check_memory, check_stats, legs

WORKLOADS = ("bc", "bfs", "fw", "hist", "join", "mm")
LEGS = [(w, p, m) for w in WORKLOADS for p in ("dae", "spec")
        for m in ("vector", "state-machine")]

__all__ = ["legs"]  # the module-scoped leg cache, one per module


@pytest.mark.parametrize("name,pname,cu_mode", LEGS)
def test_parity_memory(legs, name, pname, cu_mode):
    check_memory(legs(name, pname, cu_mode), f"{name}/{pname}/{cu_mode}")


@pytest.mark.parametrize("name,pname,cu_mode", LEGS)
def test_parity_run_fields(legs, name, pname, cu_mode):
    check_fields(legs(name, pname, cu_mode), pname, cu_mode,
                 f"{name}/{pname}/{cu_mode}")


@pytest.mark.parametrize("name,pname,cu_mode", LEGS)
def test_parity_stats(legs, name, pname, cu_mode):
    check_stats(legs(name, pname, cu_mode), pname,
                f"{name}/{pname}/{cu_mode}")
