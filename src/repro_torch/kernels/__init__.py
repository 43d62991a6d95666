"""The hand-written CUDA kernels of the codegen path and their plain versions.

:func:`repro_torch.kernels.spec_gather.spec_gather` and
:func:`repro_torch.kernels.spec_scatter.spec_scatter_add` launch their
CUDA kernel on CUDA tensors and run the plain PyTorch version
(:mod:`repro_torch.kernels.ref`) on CPU tensors — see
:mod:`repro_torch.kernels.ops`.  The attention and grouped-GEMM kernels of
the JAX package are not ported yet.
"""
