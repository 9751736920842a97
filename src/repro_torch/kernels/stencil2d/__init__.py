from repro_torch.kernels.stencil2d.kernel import (
    jacobi1d_cuda,
    jacobi1d_plain,
    stencil2d_cuda,
    stencil2d_plain,
)
from repro_torch.kernels.stencil2d.ops import jacobi1d, stencil2d
from repro_torch.kernels.stencil2d.ref import jacobi1d_ref, stencil2d_ref, weights_for
