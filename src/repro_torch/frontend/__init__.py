"""Composable DAE programs (the recording builder) and their compile cache.

* :func:`dae` / :class:`Program` — record loop nests compositionally and
  lower them through :class:`repro_torch.core.ir.LoopNest`;
* :class:`CompileCache` — a ``DAE_CACHE_DIR``-rooted persistent cache so
  repeat compiles of the same program skip decoupling, speculation,
  poisoning, classification *and* source emission, with a
  re-lowered-IR guard against stale payloads.  Its entries never
  collide with the JAX package's in a shared directory
  (:mod:`repro_torch.frontend.cache`).
"""
from .builder import FrontendError, Program, dae
from .cache import SCHEMA, CompileCache, resolve_cache

__all__ = ["CompileCache", "FrontendError", "Program", "SCHEMA", "dae",
           "resolve_cache"]
