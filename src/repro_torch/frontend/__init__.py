"""Composable DAE programs (the recording builder).

:func:`dae` / :class:`Program` record loop nests compositionally and
lower them through :class:`repro_torch.core.ir.LoopNest`.  The persistent
compile cache is not part of this package yet.
"""
from .builder import FrontendError, Program, dae

__all__ = ["FrontendError", "Program", "dae"]
