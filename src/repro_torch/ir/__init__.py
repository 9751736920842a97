"""repro_torch.ir — the stencil dataflow-graph IR and its PyTorch/CUDA lowerings.

The port of ``repro.ir`` (see README "PyTorch/CUDA port"):

    graph (StencilOp DAG) --> analysis (halo / op counts, derived; a copy of
                              the JAX package's, fingerprints equal)
        --> lower_reference   (eager PyTorch, fused or stage-at-a-time)
        --> lower_cuda        (one generated fused CUDA kernel per program:
                               K2, the port of lower_pallas; K5' for 1-D
                               programs)

Temporal blocking rides the same pipeline: ``repeat(p, k)`` fuses k sweeps
into one program whose chain both backends execute per sweep, with the
boundary ring re-applied at absolute indices between sweeps. Multi-field
and multi-output programs take and return ``{field: tensor}`` mappings.
Both lowerings report per-call timers and counters through
:mod:`repro_torch.obs.metrics` when a registry is enabled.

Derived adjoints (:mod:`repro_torch.ir.autodiff`): ``adjoint(p)`` is itself
an IR program, so gradients run through the same lowerings;
``build_backend(p, backend, differentiable=True)`` attaches it as a
``torch.autograd.Function``.

        --> lower_sharded     (rows x cols domain decomposition on
                               torch.distributed: per-field halo exchange,
                               K2 in offset mode or the evaluator per shard;
                               ``plan_partition`` picks the mesh shape)
"""

from repro_torch.ir.graph import (
    Offset,
    OpCost,
    ProgramSpec,
    Read,
    StencilOp,
    StencilProgram,
    repeat,
)
from repro_torch.ir.ops import affine, flux, product, scaled_residual, weighted_residual
from repro_torch.ir.programs import (
    ELEMENTARY_PROGRAMS,
    MULTIFIELD_PROGRAMS,
    MULTIOUTPUT_PROGRAMS,
    advection_diffusion_program,
    hdiff1d_program,
    hdiff_coupled_program,
    hdiff_multistep_program,
    hdiff_program,
    jacobi1d_program,
    jacobi2d_3pt_program,
    jacobi2d_5pt_program,
    jacobi2d_9pt_program,
    laplacian_program,
    seidel2d_program,
    shallow_water_program,
    smagorinsky_coeff,
    smooth1d_program,
    vadvc_program,
)
from repro_torch.ir.evaluate import (
    apply_program,
    embed_interior,
    interior_eval,
    interior_eval_multi,
    interior_region,
    resolve_field_arrays,
    ring_crop,
    slab_step,
    slab_sweep,
    thread_chain,
)
from repro_torch.ir.plan import (
    SMEM_BLOCK_LIMIT,
    Partition2D,
    TilePlan,
    plan_fixed_tile,
    plan_partition,
)
from repro_torch.ir.lower_reference import lower_reference
from repro_torch.ir.lower_cuda import (
    lower_cuda,
    stencil_program_1d_cuda,
    stencil_program_1d_plain,
    stencil_program_cuda,
    stencil_program_plain,
)
from repro_torch.ir.lower_sharded import lower_sharded
from repro_torch.ir.autodiff import (
    acc_field,
    adjoint,
    augmented_forward,
    cache_field,
    cache_fields,
    differentiable_lowering,
    make_vjp,
    pad_widths,
    seed_field,
)
from repro_torch.ir.lower_batched import BACKENDS, SHARDED_BACKENDS, build_backend
