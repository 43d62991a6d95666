"""Pieces of the machine model that the interpreter and the emitters share.

:mod:`repro_torch.core.sim.base` holds the ``POISON`` sentinel and
:mod:`repro_torch.core.sim.compile` the interpreter's source compiler;
the event-driven cycle machine is not part of this package yet.
"""
from .base import POISON

__all__ = ["POISON"]
