"""PyTorch/CUDA port of the DAE speculation compiler and its runtime.

The paper's main path — a workload from :mod:`repro_torch.bench_irregular`,
compiled by :func:`repro_torch.core.pipeline.compile_spec`, executed by
:func:`repro_torch.codegen.run` with ``target="torch"`` — runs its device
tables through two hand-written CUDA kernels
(:mod:`repro_torch.kernels.spec_gather`,
:mod:`repro_torch.kernels.spec_scatter`).  The serving path —
:class:`repro_torch.serve.engine.Engine` over the model stack of
:mod:`repro_torch.models` for a config of :mod:`repro_torch.configs` —
sends every MoE layer's speculative dispatch through the same two
kernels in bf16 (``dispatch="spec-kernel"``).  The package imports torch
and numpy only; the JAX package ``repro`` beside it is the reference it
is tested against.
"""
