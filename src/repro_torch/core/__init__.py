"""Core library: the paper's compound-stencil contribution in PyTorch.

Public API (the counterpart of ``repro.core``):
  hdiff, hdiff_simple, hdiff_staged       -- the COSMO horizontal-diffusion kernel
  elementary stencils (jacobi1d, ...)     -- §3.5 benchmark suite
  CompoundStencil / make_hdiff_compound   -- staged/fused execution policies
  plan_partition                          -- B-block-style partition planner
  run_simulation                          -- iterative timestep driver
  aie_hdiff_cycles / roofline_terms       -- §3.1 analytical model (AIE, TPU, H100)
"""

from repro_torch.core.analytical import (
    H100_SXM,
    H100_SXM_INT32_OPS,
    TPUV5E,
    MachineModel,
    aie_hdiff_cycles,
    aie_stencil_cycles,
    arithmetic_intensity,
    dominant_term,
    roofline_fraction,
    roofline_terms,
)
from repro_torch.core.compound import (
    CompoundStencil,
    PartitionPlan,
    StencilStage,
    make_hdiff_compound,
    plan_partition,
)
from repro_torch.core.hdiff import (
    HALO,
    HDIFF_SPEC,
    hdiff,
    hdiff_algorithmic_bytes,
    hdiff_flops,
    hdiff_min_bytes,
    hdiff_simple,
    hdiff_staged,
)
from repro_torch.core.stencils import (
    ELEMENTARY_FNS,
    ELEMENTARY_SPECS,
    StencilSpec,
    jacobi1d,
    jacobi2d_3pt,
    jacobi2d_5pt,
    jacobi2d_9pt,
    lap_field,
    laplacian,
    seidel2d_exact,
    seidel2d_sweep,
)
from repro_torch.core.timestep import make_initial_field, run_simulation
