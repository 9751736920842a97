"""Analytical performance model — the paper's §3.1, with TPU and H100 constants.

The port's copy of ``repro/core/analytical.py``: the AIE model and the
three-term roofline are verbatim, and :data:`H100_SXM` joins
:data:`TPUV5E` as the machine the port's planner defaults to.

The paper derives per-kernel *compute cycles* (Eq. 5-7) and *memory cycles*
(Eq. 8-10) for an AIE core (8 fp32 MACs/cycle, 2x256-bit loads/cycle) and
uses the ratio to decide how to split hdiff across cores. We reproduce that
model verbatim (:func:`aie_cycles`) for the faithful-reproduction benchmarks,
and generalise it to the three-term roofline the dry-run reports:

    compute_s    = flops / (chips * peak_flops)
    hbm_s        = bytes / (chips * hbm_bw)
    collective_s = coll_bytes / (chips * ici_bw)

Hardware constants per the brief: TPU v5e — 197 TFLOP/s bf16 per chip,
819 GB/s HBM, ~50 GB/s/link ICI. fp32 MXU throughput is modelled at half
the bf16 number; VPU-bound (non-matmul) stencil math is modelled separately
because stencils run on the VPU, not the MXU.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip (MXU)
    peak_flops_f32: float       # FLOP/s per chip (MXU, fp32)
    peak_flops_vpu_f32: float   # FLOP/s per chip (vector unit; stencil path)
    hbm_bw: float               # bytes/s per chip
    ici_bw: float               # bytes/s per link
    hbm_gib: float              # HBM capacity per chip
    vmem_bytes: int             # VMEM per core


# TPU v5e (brief constants; VPU estimated at 8 lanes x 128 sublanes x 2 flops
# x 940MHz-class clock ~= 2 TFLOP/s f32 -- order-of-magnitude for planning).
TPUV5E = MachineModel(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    peak_flops_f32=98.5e12,
    peak_flops_vpu_f32=2.0e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_gib=16.0,
    vmem_bytes=128 * 1024 * 1024,
)

# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet; dense rates,
# no sparsity, at the 700 W board power). Stencils run on the CUDA cores,
# not the tensor cores, so the "vpu" rate of the roofline is the FP32
# non-tensor peak; a float32 matmul in full precision (TF32 off, the port's
# setting) runs there too.
H100_SXM = MachineModel(
    name="h100_sxm",
    peak_flops_bf16=989e12,       # data sheet: BF16 tensor core, dense
    peak_flops_f32=67e12,         # data sheet: FP32 (non-tensor)
    peak_flops_vpu_f32=67e12,     # data sheet: FP32 (non-tensor), the stencil path
    hbm_bw=3.35e12,               # data sheet: HBM3, 3.35 TB/s
    ici_bw=900e9,                 # data sheet: NVLink, 900 GB/s per GPU
    hbm_gib=80e9 / 2**30,         # data sheet: 80 GB (decimal) of HBM3
    vmem_bytes=227 * 1024,        # shared memory one block can use (H100 white paper)
)
# Not MachineModel fields: the H100's 50 MB L2 (data sheet) holds a whole
# 64x256x256 float32 field, 16.8 MB, so kernel times on the paper grid can
# beat the device-memory bound when the input is still resident in L2. The
# data sheet gives no int32 ALU rate; an SM has 64 INT32 lanes against 128
# FP32 lanes (H100 white paper), so the int32 peak is taken as half the FP32
# non-tensor rate, counting a multiply-add as two operations like a FLOP.
H100_SXM_INT32_OPS = 67e12 / 2

# The paper's AIE core (for the faithful §3.1 reproduction): 8 fp32 MACs/cycle,
# two 256-bit loads/cycle, 1 GHz.
AIE_MACS_PER_CYCLE = 8
AIE_LOAD_BITS_PER_CYCLE = 2 * 256
AIE_CLOCK_HZ = 1.0e9


def aie_hdiff_cycles(rows: int, cols: int, depth: int) -> dict[str, float]:
    """Paper Eq. 5-10, verbatim: min compute & memory cycles for one sweep."""
    interior = (rows - 4) * (cols - 4) * depth
    lap_comp = 5 * interior * 5 / AIE_MACS_PER_CYCLE                      # Eq. 5
    flux_comp = (2 * interior * 4) / AIE_MACS_PER_CYCLE + (
        3 * (1 * interior * 4)
    ) / AIE_MACS_PER_CYCLE                                                # Eq. 6
    lap_mem = 5 * interior * 5 * 32 / AIE_LOAD_BITS_PER_CYCLE             # Eq. 8
    flux_mem = 2 * interior * 4 * 32 / AIE_LOAD_BITS_PER_CYCLE            # Eq. 9
    return {
        "laplacian_compute_cycles": lap_comp,
        "flux_compute_cycles": flux_comp,
        "hdiff_compute_cycles": lap_comp + flux_comp,                     # Eq. 7
        "laplacian_memory_cycles": lap_mem,
        "flux_memory_cycles": flux_mem,
        "hdiff_memory_cycles": lap_mem + flux_mem,                        # Eq. 10
    }


def aie_stencil_cycles(
    spec, rows: int, cols: int, depth: int, *, itemsize_bits: int = 32
) -> dict[str, float]:
    """AIE cycle estimate for ANY stencil from its (graph-derived) spec.

    ``spec`` is anything with ``macs`` / ``other_ops`` / ``reads`` / ``radius``
    per-output-point fields (``repro.ir.ProgramSpec`` or ``StencilSpec``).
    Compute charges one cycle per ``AIE_MACS_PER_CYCLE`` ops (MAC and non-MAC
    vector ops issue at the same rate on the AIE VLIW slots); memory charges
    ``spec.reads`` — the composed *distinct-element* footprint, i.e. WITH
    register reuse. This is deliberately NOT the same accounting as
    :func:`aie_hdiff_cycles`, which reproduces Eq. 5-10 verbatim (every
    stage re-streams its operands — 33 reads/point for hdiff vs 13 here, and
    Eq. 7 excludes the output stage — 45 ops vs this model's 46). Use
    ``aie_hdiff_cycles`` for paper-faithful hdiff numbers and this function
    for planning new graph-defined stencils.
    """
    side = 2 * spec.radius
    interior = max(rows - side, 0) * max(cols - side, 0) * depth
    compute = interior * (spec.macs + spec.other_ops) / AIE_MACS_PER_CYCLE
    memory = interior * spec.reads * itemsize_bits / AIE_LOAD_BITS_PER_CYCLE
    return {
        "compute_cycles": compute,
        "memory_cycles": memory,
        "bound": "memory" if memory > compute else "compute",
        "seconds": max(compute, memory) / AIE_CLOCK_HZ,
    }


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    ici_bytes: float,
    machine: MachineModel = TPUV5E,
    *,
    dtype: str = "f32",
    unit: str = "vpu",
) -> tuple[float, float, float]:
    """Three-term roofline (seconds) for ONE chip's share of work.

    ``unit`` selects the compute peak: "mxu" for matmul-dominated work,
    "vpu" for elementwise/stencil work (stencils never touch the MXU).
    """
    if unit == "vpu":
        peak = machine.peak_flops_vpu_f32
    elif dtype == "bf16":
        peak = machine.peak_flops_bf16
    else:
        peak = machine.peak_flops_f32
    return (
        flops / peak,
        hbm_bytes / machine.hbm_bw,
        ici_bytes / machine.ici_bw if ici_bytes else 0.0,
    )


def dominant_term(compute_s: float, hbm_s: float, ici_s: float) -> str:
    terms = {"compute": compute_s, "memory": hbm_s, "collective": ici_s}
    return max(terms, key=terms.get)  # type: ignore[arg-type]


def arithmetic_intensity(flops: float, hbm_bytes: float) -> float:
    return flops / max(hbm_bytes, 1)


def roofline_fraction(
    achieved_flops_per_s: float,
    flops: float,
    hbm_bytes: float,
    machine: MachineModel = TPUV5E,
    *,
    unit: str = "vpu",
    dtype: str = "f32",
) -> float:
    """Fraction of the *attainable* roofline (min of compute peak and
    bandwidth * AI), the paper's 'Ach. Roof.' column in Table 2."""
    if unit == "vpu":
        peak = machine.peak_flops_vpu_f32
    elif dtype == "bf16":
        peak = machine.peak_flops_bf16
    else:
        peak = machine.peak_flops_f32
    attainable = min(peak, machine.hbm_bw * arithmetic_intensity(flops, hbm_bytes))
    return achieved_flops_per_s / attainable
