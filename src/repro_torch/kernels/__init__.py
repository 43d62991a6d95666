"""The hand-written CUDA kernels of the port and their plain versions.

:mod:`repro_torch.kernels.ops` is the public API, the counterpart of
``repro.kernels.ops``: ``spec_gather`` and ``spec_scatter_add`` (the
codegen path's speculative gather and scatter, and the MoE dispatch's
buffer fill and combine), ``ragged_matmul`` (the
grouped expert GEMM), ``flash_attention`` and ``paged_attention``.  Each
launches its CUDA kernel (``csrc/*.cu``, built by
:mod:`repro_torch.kernels.build`) on CUDA tensors and runs the plain
PyTorch version (:mod:`repro_torch.kernels.ref`) on CPU tensors — see
:mod:`repro_torch.kernels.dispatch`.  Every Pallas kernel of the JAX
package has its counterpart here.
"""
