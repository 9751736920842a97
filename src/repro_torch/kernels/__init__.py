"""Hand-written Hopper kernels: the paper's stencil hot-spots and the recurrent LMs' scans.

hdiff/      fused compound stencil (K1) and its int32 datapath (K3)
stencil2d/  the §3.5 elementary stencils: a runtime 3x3 mask (K4) and the
            1-D Jacobi sweep (K5)
rglru/      the RG-LRU linear recurrence of RecurrentGemma's prefill (K6)
wkv6/       the chunked RWKV-6 WKV recurrence of RWKV-6's prefill (K7)
stats/      the health probe's field statistics in one read (no Pallas site)

Each kernel ships its CUDA source under ``repro_torch/csrc/``, a wrapper
module that builds it at first use (``_build``), checks and launches it,
and its plain PyTorch version beside the wrapper, which the wrapper runs
for CPU tensors and ``chip_smoke.py`` holds the kernel against on the card.
"""
