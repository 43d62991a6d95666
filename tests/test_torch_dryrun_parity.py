"""The port's sharded steps communicate as the reference's do: each
package's dry-run CLI on the same cell, per-device collective bytes
compared.

``python -m repro.launch.dryrun`` (512 forced host devices, XLA's SPMD
partitioner, the compiled module's collectives read by
``repro.launch.hlo_cost``) and ``python -m repro_torch.launch.dryrun`` (a
fake 256-rank process group, DTensor and the port's shard-by-shard
layers, counted by ``repro_torch.launch.cost``) run the cell in two
subprocesses side by side.  For each cell:

* the port's total collective bytes are within a factor of 2 of the
  reference's, either way;
* the port's all-gather bytes are at most twice the reference's plus 5%
  of the reference's total (a gather the reference does not make, such
  as a KV cache gathered to write one token, fails this).

Both packages reduce partial sums in the activations' dtype, but XLA's
CPU backend, on which the reference's dry run compiles, promotes a bf16
all-reduce or reduce-scatter to float32, and the reference counts what
it compiled.  The port's side of the comparison is therefore its
``collective_bytes_xla_cpu`` (the same collectives, 16-bit floating
reductions at 4 bytes an element); its ``collective_bytes`` are what
would cross the wire, and what its roofline uses.

FLOPs and matmul bytes are not compared: the reference's HLO parser
reads a batched ``dot`` as no work (:func:`test_reference_counts_no_
batched_dot`), so its FLOPs leave out the expert FFN and the attention
products, which the port counts.

This file holds the decode and prefill cells; the training cells, which
take longer, are in ``tests/test_torch_dryrun_parity_train.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [("kimi_k2_1t_a32b", "decode_32k"),
         ("mistral_nemo_12b", "decode_32k"),
         ("mistral_nemo_12b", "prefill_32k"),
         ("jamba_1_5_large_398b", "decode_32k"),
         # the cross sublayers' K/V heads split in halves over ``model``
         ("llama_3_2_vision_90b", "decode_32k")]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def dryrun_pair(arch: str, shape: str, tmp) -> tuple:
    """The reference's and the port's records of one cell, their two
    CLIs run side by side (the reference sets its own ``XLA_FLAGS`` on
    import)."""
    outs = [str(tmp / f"{pkg}.json") for pkg in ("ref", "port")]
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out], env=_env(), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for pkg, out in zip(("repro", "repro_torch"), outs)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    recs = []
    for out in outs:
        with open(out) as fh:
            recs.append(json.load(fh))
    return tuple(recs)


def check_collectives(ref: dict, port: dict) -> None:
    """The two checks of the module docstring."""
    rc, pc = ref["collective_bytes"], port["collective_bytes_xla_cpu"]
    ratio = pc["total"] / rc["total"]
    assert 0.5 <= ratio <= 2.0, (
        f"port {pc['total']:.4g} collective bytes a device against the "
        f"reference's {rc['total']:.4g} ({ratio:.3g}x): {pc} vs {rc}")
    bound = 2 * rc["all-gather"] + 0.05 * rc["total"]
    assert pc["all-gather"] <= bound, (
        f"port all-gathers {pc['all-gather']:.4g} bytes a device, past "
        f"{bound:.4g} (2x the reference's {rc['all-gather']:.4g} + 5% of "
        f"its total)")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_collectives_match_reference(arch, shape, tmp_path):
    ref, port = dryrun_pair(arch, shape, tmp_path)
    assert port["n_devices"] == ref["n_devices"] == 256
    check_collectives(ref, port)


def test_reference_counts_no_batched_dot():
    """A property of the reference not copied: ``analyze_hlo``'s dot
    pattern expects ``lhs_contracting_dims`` right after the operands,
    but HLO prints ``lhs_batch_dims`` first, so a batched ``dot`` reads
    0 FLOPs.  On a 24 x 8 x 64 x 32 ``ecd,edf->ecf`` einsum the port's
    counter reads 2 * 24 * 8 * 32 * 64 = 786,432."""
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_cost import analyze_hlo

    from repro_torch.launch.cost import CostCounter
    a = jax.ShapeDtypeStruct((24, 8, 64), jnp.float32)
    b = jax.ShapeDtypeStruct((24, 64, 32), jnp.float32)
    hlo = jax.jit(lambda x, y: jnp.einsum("ecd,edf->ecf", x, y)).lower(
        a, b).compile().as_text()
    assert "lhs_batch_dims" in hlo
    assert analyze_hlo(hlo)["dot_flops"] == 0.0
    counter = CostCounter()
    with counter:
        torch.einsum("ecd,edf->ecf", torch.ones(24, 8, 64),
                     torch.ones(24, 64, 32))
    assert counter.totals()["dot_flops"] == 786_432
