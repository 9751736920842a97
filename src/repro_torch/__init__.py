"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Same subpackage layout as the JAX package: ``ir`` (the stencil IR, its
eager and fused-CUDA lowerings), ``core`` (hand-written stencils, execution
policies, time stepping, the analytical model), ``kernels`` (hand-written
CUDA kernels, sources under ``csrc/``, built at first use into
``build/repro_torch/``), ``configs``. It imports torch and numpy, never JAX
and nothing of ``repro``.

Device rule (:mod:`repro_torch.device`): entry points that create tensors
default to the card; entry points that take tensors run where they live.
"""
