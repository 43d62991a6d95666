"""Per-array request streams — the software-prefetcher artifact.

Running the AGU slice ahead of time (legal after
:func:`repro.codegen.analysis.analyze` classified it pure-address or
sync-read-only) yields, per decoupled array, the ordered request stream the
DU would have seen: an interleaving of load and store *addresses* in AGU
program order.  The paper's same-array FIFO discipline (hazard rules i/ii
in :mod:`repro.core.speculation`, the in-order LSQ in
:mod:`repro.core.sim.units`) guarantees the CU's per-array
consume/produce/poison order matches this stream exactly — which is what
lets the generated CU kernels treat ``consume_ld`` as "read the next
precomputed address" and ``produce_st``/``poison_st`` as "write (or
poison-skip) the next precomputed address".

Mis-speculated requests are *present* in the stream (the AGU fired them
unconditionally after hoisting); which store slots carry the poison marker
is decided by the CU replay, exactly as the DU drops poisoned commits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Streams:
    """Ahead-of-time AGU output: per-array request streams in AGU issue
    order, already split into the flat views the generated kernels index
    (the emitted AGU runner fills these directly as it executes):

    * ``ld_raw``     — load addresses as computed (the LSQ disambiguates
      on raw addresses);
    * ``ld_clamped`` — the same loads clamped to ``[0, len-1]`` (the LSQ's
      speculative clamp: a hoisted mis-speculation may compute any index);
    * ``st_addrs``   — raw store addresses (a *committed* store must be in
      bounds; the generated code re-checks, mirroring the LSQ);
    * ``ld_pos``/``st_pos`` — each request's position in the combined
      per-array stream, used by the jax driver's epoch scheduler to keep
      device gathers behind unflushed aliasing stores.
    """

    ld_raw: Dict[str, List[int]] = field(default_factory=dict)
    ld_clamped: Dict[str, List[int]] = field(default_factory=dict)
    st_addrs: Dict[str, List[int]] = field(default_factory=dict)
    ld_pos: Dict[str, List[int]] = field(default_factory=dict)
    st_pos: Dict[str, List[int]] = field(default_factory=dict)
    #: AGU-side sync loads resolved against initial memory
    sync_reads: int = 0

    @property
    def arrays(self) -> Tuple[str, ...]:
        """Decoupled array names, in stream-dict order."""
        return tuple(self.ld_raw)

    @property
    def n_loads(self) -> int:
        """Total load requests across all arrays."""
        return sum(len(v) for v in self.ld_raw.values())

    @property
    def n_stores(self) -> int:
        """Total store requests across all arrays."""
        return sum(len(v) for v in self.st_addrs.values())
