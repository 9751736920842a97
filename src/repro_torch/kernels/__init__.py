"""Hand-written Hopper kernels for the paper's compute hot-spots.

hdiff/      fused compound stencil (K1) and its int32 datapath (K3)
stencil2d/  the §3.5 elementary stencils: a runtime 3x3 mask (K4) and the
            1-D Jacobi sweep (K5)

Each kernel ships its CUDA source under ``repro_torch/csrc/``, a wrapper
module that builds it at first use (``_build``), checks and launches it,
and its plain PyTorch version beside the wrapper, which the wrapper runs
for CPU tensors and ``chip_smoke.py`` holds the kernel against on the card.
"""
