"""Per-device cost of one step, counted as it runs.

The counterpart of the JAX package's ``launch/hlo_cost.py``.  There is
no HLO here: :class:`CostCounter` is a ``TorchDispatchMode`` that sees
every operation a rank runs and counts

* the FLOPs of the matrix products (2 x result elements x contraction
  size: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``) and
  their bytes (operands read once, result written once);
* the bytes of each collective by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), as the
  reference counts them: the size of the collective's result;
* the bytes of the operations' outputs alive at once, their peak (an
  estimate of the step's temporaries: views and in-place results are
  not new memory).

The counts are **per device**, as the reference's (HLO after SPMD
partitioning).  A DTensor operation is not counted where it is seen:
the counter returns ``NotImplemented``, DTensor runs its local
operations on the rank's shards (and the collectives its sharding
needs), and those come back to the counter as plain-tensor operations,
which it counts.  DTensor also runs an operation on fake tensors of
the global shapes to infer its output; that is no rank's work, and the
counter marks that step (it wraps the sharding propagator's tensor-meta
step while active) and leaves it out (counted, it would add the global
product to the local one).  The reference multiplies a ``while``
body by its trip count; the port's loops (the layer groups, the
attention chunks) are Python loops, counted a step at a time, so the
same loop gives the same total.  Inside :meth:`CostCounter.repeat`
every count is multiplied: the dry run counts the SSM scans' second
step and multiplies it by the steps that follow (the reference's rule
for a ``while`` body), since a step's cost does not depend on its
values.

:meth:`CostCounter.totals` returns the keys of the reference's ``analyze_hlo``:
``dot_flops``, ``dot_bytes``, one key per collective kind that occurred
and ``collective_total``.  :meth:`CostCounter.xla_cpu_totals` gives the
collective bytes as the reference's dry run counts the same program:
XLA's CPU backend promotes a 16-bit floating all-reduce or
reduce-scatter to float32, so its counts hold those at 4 bytes an
element.  Both packages reduce in the activations' dtype; the second
count is for comparing with the reference only.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: collective kinds, the reference's names
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: (namespace, op) of each collective -> its kind
_COLLECTIVES = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
}

#: the in-place ``c10d`` collectives whose result is their first argument
#: (the output buffers); the functional ones return it
_C10D_OUT_ARG = {"allreduce_", "allreduce_coalesced_", "allgather_",
                 "_allgather_base_", "allgather_into_tensor_coalesced_",
                 "reduce_scatter_", "_reduce_scatter_base_",
                 "reduce_scatter_tensor_coalesced_", "alltoall_",
                 "alltoall_base_"}


#: the reducing collectives, which XLA's CPU backend runs in float32
#: for 16-bit floats
_PROMOTED = ("all-reduce", "reduce-scatter")


def _nbytes(x, promote: bool = False) -> int:
    """Bytes of the tensors in ``x`` (a tensor or nested lists of them);
    with ``promote``, 16-bit floats at 4 bytes an element."""
    if isinstance(x, torch.Tensor):
        size = x.element_size()
        if promote and x.dtype in (torch.bfloat16, torch.float16):
            size = 4
        return x.numel() * size
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v, promote) for v in x)
    return 0


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def matmul_cost(name: str, args) -> tuple:
    """``(flops, bytes)`` of one matrix product on plain tensors, or
    ``(0, 0)`` for any other operation."""
    if name in ("mm", "bmm", "mv", "dot"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        return 0, 0
    k = a.shape[-1]
    if name == "mv":
        out = (a.shape[0],)
    elif name == "dot":
        out = ()
    else:
        out = tuple(a.shape[:-1]) + (b.shape[-1],)
    elems = _numel(out)
    flops = 2 * elems * k
    nbytes = _nbytes(a) + _nbytes(b) + elems * a.element_size()
    if name in ("addmm", "baddbmm"):
        nbytes += _nbytes(args[0])
    return flops, nbytes


def _hook_inference(counter: "CostCounter"):
    """Mark DTensor's output-shape inference (which runs the operation
    on fake tensors of the global shapes) so the counter can leave it
    out; returns the function that removes the mark."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    # the uncached step of the inference (torch 2.6 on), else the step
    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta") if hasattr(prop, n)]
    if not names:
        raise RuntimeError("DTensor's sharding propagator has no tensor-"
                           "meta step to hook; the counter would count "
                           "the global products")
    name = names[0]
    own = name in vars(prop)
    inner = getattr(prop, name)

    def marked(*args, **kwargs):
        counter._inferring += 1
        try:
            return inner(*args, **kwargs)
        finally:
            counter._inferring -= 1

    setattr(prop, name, marked)

    def unhook():
        if own:
            setattr(prop, name, inner)
        else:
            delattr(prop, name)

    return unhook


class CostCounter(TorchDispatchMode):
    """Counts one rank's matmul FLOPs and bytes, collective bytes by kind
    and the peak of live operation outputs while it is active (module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.dot_bytes = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.collectives_xla_cpu: Dict[str, int] = defaultdict(int)
        self.collective_calls: Dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._inferring = 0
        self._unhook = None
        self._times = 1

    def __enter__(self):
        self._unhook = _hook_inference(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unhook()

    @contextlib.contextmanager
    def repeat(self, n: int) -> Iterator[None]:
        """Count every operation in the block ``n`` times (a loop body
        that runs ``n`` times with the same shapes)."""
        before = self._times
        self._times = before * n
        try:
            yield
        finally:
            self._times = before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # count the local operations instead
        out = func(*args, **kwargs)
        if self._inferring:  # DTensor's shape inference: no rank's work
            return out
        namespace, _, name = func.name().partition("::")
        if namespace == "aten":
            flops, nbytes = matmul_cost(name, args)
            self.dot_flops += flops * self._times
            self.dot_bytes += nbytes * self._times
            self._track(func, out)
        kind = _COLLECTIVES.get((namespace, name))
        if kind is not None:
            result = args[0] if (namespace == "c10d"
                                 and name in _C10D_OUT_ARG) else out
            self.collectives[kind] += _nbytes(result) * self._times
            self.collectives_xla_cpu[kind] += _nbytes(
                result, kind in _PROMOTED) * self._times
            self.collective_calls[kind] += self._times
        return out

    def _track(self, func, out) -> None:
        """Add a new output's bytes to the live total until it dies;
        views and in-place results are no new memory."""
        if not isinstance(out, torch.Tensor) or any(
                r.alias_info is not None for r in func._schema.returns):
            return
        n = _nbytes(out)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(out, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def totals(self) -> Dict[str, float]:
        """The reference's ``analyze_hlo`` keys (per device)."""
        out: Dict[str, float] = {"dot_flops": float(self.dot_flops),
                                 "dot_bytes": float(self.dot_bytes)}
        out.update({k: float(v) for k, v in self.collectives.items()})
        out["collective_total"] = float(sum(
            v for k, v in self.collectives.items() if k in KINDS))
        return out

    def xla_cpu_totals(self) -> Dict[str, float]:
        """The collective bytes by kind and their ``collective_total``,
        16-bit floating reductions counted at 4 bytes an element, as the
        reference's dry run on XLA's CPU backend counts them."""
        out = {k: float(v) for k, v in self.collectives_xla_cpu.items()}
        out["collective_total"] = float(sum(
            v for k, v in self.collectives_xla_cpu.items() if k in KINDS))
        return out

