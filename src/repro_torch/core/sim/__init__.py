"""Event-driven simulation core for the DAE machine model.

Layout:

* :mod:`~repro_torch.core.sim.base`   — ``MachineConfig`` / ``MachineResult`` /
  ``Deadlock`` / ``POISON`` (the API types).
* :mod:`~repro_torch.core.sim.events` — the ``(ready_cycle, unit)`` wakeup heap.
* :mod:`~repro_torch.core.sim.fifo`   — bounded latency-FIFOs with wakeup edges.
* :mod:`~repro_torch.core.sim.units`  — AGU/CU slice processes, the per-array
  LSQ (DU), and the :class:`~repro_torch.core.sim.units.Machine` event loop.

* :mod:`~repro_torch.core.sim.compile` — slices, the STA schedule and the
  sequential interpreter lowered to Python source.

The public entry point is :func:`repro_torch.core.machine.run_dae`, which
fronts this package.  The package is the JAX package's simulator, which
never imported JAX, carried into the port: ``tests/test_torch_sim.py``
holds its cycles, counters, store traces and memory bit for bit to the
reference's in every engine mode.
"""
from .base import Deadlock, MachineConfig, MachineResult, POISON
from .events import INF, EventQueue
from .fifo import Fifo
from .units import LSQ, Machine, SliceProc, run_dae

__all__ = ["Deadlock", "MachineConfig", "MachineResult", "POISON", "INF",
           "EventQueue", "Fifo", "LSQ", "Machine", "SliceProc", "run_dae"]
