"""torch target: drive the generated CU through the CUDA kernel layer.

Counterpart of the JAX package's state-machine device driver.  The
decoupled arrays live on the device as ``(n, 1)`` ``torch.int32`` tables;
the generated CU (:func:`repro_torch.codegen.emit.compile_mode` in
``cu-jax`` mode — plain Python, the name is the reference's) runs as a
host-side generator that *yields* an array name whenever its load-value
buffer runs dry.  On each yield the driver

1. **flushes** every store value the CU has produced for that array —
   poisoned slots become ``-1`` indices, which
   :func:`repro_torch.kernels.spec_scatter.spec_scatter_add_staged` drops
   at commit; an overwrite store lowers to gather-current + scatter-add of
   the delta, computed in int32 on the host from the gathered rows, which
   is bit-exact in two's-complement arithmetic; write-after-write
   collisions split the flush so in-order commit is preserved;
2. **refills** the buffer with the next *epoch* of load values via
   :func:`repro_torch.kernels.spec_gather.spec_gather_staged`: the epoch
   extends from the next unconsumed load up to (but excluding) the first
   load whose raw address aliases a still-unflushed store request.

Both kernels go by the staged route: the requests are written straight
into a slot of one :class:`~repro_torch.kernels.staging.Ring` per run,
with no per-call copy or device tensor, and unpadded (the reference pads
each batch to a power of two to bound JAX retraces).  The kernel calls —
and what an armed fault plan sees — match the reference call for call.

Subset rules (anything else raises ``CodegenError`` and the caller falls
back): decoupled arrays must be integer-typed with all values — initial
and produced — representable in int32.  Within that range the delta trick
and the int32 device arithmetic are exact, so final memory is bit-identical
to the sequential interpreter.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict

import numpy as np
import torch

from ..kernels.spec_gather import spec_gather_staged
from ..kernels.spec_scatter import spec_scatter_add_staged
from ..kernels.staging import Ring
from ..resilience import faults
from ..resilience.faults import FaultDetected
from .analysis import CodegenError
from .emit import compile_mode
from .epochs import I32_MAX as _I32_MAX
from .epochs import I32_MIN as _I32_MIN
from .epochs import MAX_BATCH, gather_limit
from .streams import Streams


def _check_i32(name: str, arr: np.ndarray) -> None:
    """Refuse a decoupled array the int32 device table cannot hold."""
    if arr.dtype.kind not in "iu":
        raise CodegenError(
            f"torch target: decoupled array {name} has non-integer dtype "
            f"{arr.dtype}")
    if arr.size and (int(arr.min()) < _I32_MIN or int(arr.max()) > _I32_MAX):
        raise CodegenError(
            f"torch target: {name} holds values outside int32 range")


class _ArrayDriver:
    """Epoch scheduler for one decoupled array."""

    def __init__(self, name: str, mem: np.ndarray, streams: Streams,
                 device: torch.device, ring: Ring):
        self.name = name
        self.hi = len(mem) - 1
        self.ring = ring
        self.table = torch.from_numpy(
            mem.astype(np.int32).reshape(-1, 1)).to(device)
        # shadow replica of the device table, kept only when the armed
        # plan can silently corrupt data (see faults.CORRUPTION_SITES):
        # exact by induction (only these flushes mutate the table), so
        # any divergence is detected corruption.  None otherwise — the
        # hot path keeps zero copies.
        self.shadow = mem.astype(np.int32) if faults.corrupting() else None
        self.ld_clamped = streams.ld_clamped.get(name, [])
        self.ld_raw = streams.ld_raw.get(name, [])
        self.ld_pos = streams.ld_pos.get(name, [])
        self.st_addrs = streams.st_addrs.get(name, [])
        self.st_pos = streams.st_pos.get(name, [])
        self.lp = 0          # next unconsumed load index
        self.fp = 0          # flushed store count
        self.gather_calls = 0
        self.scatter_calls = 0

    # -- store flush ---------------------------------------------------------
    def flush(self, produced: list) -> None:
        """Apply ``produced`` (values / POISON sentinels) in commit order."""
        from ..core.sim.base import POISON
        faults.inject("codegen.jax.flush")
        if not produced:
            return
        if self.fp + len(produced) > len(self.st_addrs):
            raise CodegenError(f"store stream underrun @{self.name}")
        addrs = self.st_addrs[self.fp:self.fp + len(produced)]
        idx_b: list = []
        val_b: list = []
        seen = set()
        for a, v in zip(addrs, produced):
            poison = v is POISON
            if len(idx_b) >= MAX_BATCH or (not poison and a in seen):
                self._scatter(idx_b, val_b)
                idx_b, val_b, seen = [], [], set()
            if poison:
                idx_b.append(-1)
                val_b.append(0)
                continue
            if not (0 <= a <= self.hi):
                raise CodegenError(
                    f"non-poisoned store out of bounds: {self.name}[{a}]")
            iv = int(v)
            if iv < _I32_MIN or iv > _I32_MAX:
                raise CodegenError(
                    f"torch target: store value outside int32 range "
                    f"@{self.name}")
            seen.add(a)
            idx_b.append(a)
            val_b.append(iv)
        if idx_b:
            self._scatter(idx_b, val_b)
        self.fp += len(produced)
        del produced[:]

    def _scatter(self, idx_list: list, val_list: list) -> None:
        n = len(idx_list)
        idx = np.asarray(idx_list, np.int32)
        slot = self.ring.acquire(n)
        slot.idx[:n] = idx
        cur = spec_gather_staged(self.table, slot, n)
        # int32 - int32 stays int32 and wraps: the scatter-add re-wraps,
        # so the committed value is exact in two's-complement
        delta = slot.val[:n]
        np.subtract(np.asarray(val_list, np.int32), cur, out=delta)
        delta[idx < 0] = 0
        # the gather's allpoison fault may have overwritten the indices;
        # the scatter commits the flush's own
        slot.idx[:n] = idx
        self.table = spec_scatter_add_staged(self.table, slot, n)
        self.gather_calls += 1
        self.scatter_calls += 1
        if self.shadow is not None:
            # flush splits batches on duplicate addresses, so zip order
            # here is commit order
            for a, v in zip(idx_list, val_list):
                if a >= 0:
                    self.shadow[a] = v

    # -- load refill ---------------------------------------------------------
    def refill(self, buf: deque) -> int:
        """Gather the next epoch of load values into ``buf``."""
        faults.inject("codegen.jax.refill")
        lds = self.ld_clamped
        if self.lp >= len(lds):
            return 0
        # epoch boundary (shared scheduler, pessimistic fence): stop
        # before the first load whose raw address aliases an unflushed
        # (>= fp) store request that is older in the combined stream —
        # its value must come through a flush first
        k = gather_limit(self.ld_raw, self.ld_pos, self.st_addrs,
                         self.st_pos, self.lp, self.fp)
        take = lds[self.lp:k]
        if not take:
            return 0
        n = len(take)
        slot = self.ring.acquire(n)
        slot.idx[:n] = take
        got = spec_gather_staged(self.table, slot, n)
        self.gather_calls += 1
        if self.shadow is not None:
            exp = self.shadow[np.asarray(take, dtype=np.int64)]
            if not np.array_equal(got, exp):
                raise FaultDetected(
                    "codegen.jax.refill",
                    f"gather verify failed @{self.name}: device rows "
                    f"differ from shadow replica")
        buf.extend(int(x) for x in got)
        self.lp = k
        return n


def run_torch(compiled, memory: Dict[str, np.ndarray],
              params: Dict[str, Any], streams: Streams, analysis,
              *, device: torch.device,
              max_steps: int = 2_000_000) -> Dict[str, Any]:
    """Execute the CU against device tables; mutates ``memory`` on success.

    Raises :class:`CodegenError` (memory untouched) when the run leaves
    the supported subset — the caller decides whether to fall back.
    """
    cu_make = compile_mode(compiled.cu, "cu-jax")
    if cu_make is None:
        raise CodegenError("CU slice not lowerable for the torch target")

    dec = sorted(set(streams.arrays) | set(analysis.decoupled))
    for a in dec:
        _check_i32(a, memory[a])

    ring = Ring(device)
    drivers = {a: _ArrayDriver(a, memory[a], streams, device, ring)
               for a in dec}
    bufs: Dict[str, deque] = {a: deque() for a in dec}
    outs: Dict[str, list] = {a: [] for a in dec}
    stats: Dict[str, Any] = {}

    gen = cu_make(memory, dict(params), bufs, outs, stats, max_steps)
    while True:
        try:
            arr = next(gen)
        except StopIteration:
            break
        drv = drivers[arr]
        drv.flush(outs[arr])
        if drv.refill(bufs[arr]) == 0:
            raise CodegenError(
                f"torch target: CU blocked on {arr} but no gatherable loads "
                f"remain (stream mismatch)")
    for a in dec:  # drain store values produced after the last consume
        drivers[a].flush(outs[a])

    # one read-back per table serves both the integrity barrier and the
    # write-back
    tabs = {a: drivers[a].table[:, 0].cpu().numpy() for a in dec}
    # integrity barrier: before the first write to caller memory, every
    # device table must agree with its shadow replica (armed runs only —
    # a scatter that dropped or corrupted committed stores is caught
    # here at the latest, never committed)
    for a in dec:
        drv = drivers[a]
        if drv.shadow is not None and not np.array_equal(tabs[a],
                                                         drv.shadow):
            raise FaultDetected(
                "codegen.jax.commit",
                f"device table for {a} diverged from shadow replica")

    # every flush succeeded — only now touch the caller's memory (the CU
    # epilogue deliberately left its local-array mirrors in stats)
    for a, mirror in stats.pop("locals", {}).items():
        memory[a][:] = mirror
    for a in dec:
        memory[a][:] = tabs[a].astype(memory[a].dtype)
    stats["gather_calls"] = sum(d.gather_calls for d in drivers.values())
    stats["scatter_calls"] = sum(d.scatter_calls for d in drivers.values())
    # leftover contract (same meaning on every path, incl. the coupled
    # interpreter and the vectorised CU): requests the AGU issued that the
    # CU never consumed/valued — legitimate speculative over-issue past CU
    # exit.  Values gathered into a buffer but never popped still count.
    stats["ld_leftover"] = sum(len(d.ld_clamped) - d.lp + len(bufs[a])
                               for a, d in drivers.items())
    stats["st_leftover"] = sum(len(d.st_addrs) - d.fp
                               for d in drivers.values())
    return stats
