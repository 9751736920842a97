from repro_torch.kernels.hdiff.multistep import hdiff_twostep
from repro_torch.kernels.hdiff.ops import hdiff_fixed, hdiff_fused, hdiff_fused_ad
from repro_torch.kernels.hdiff.ref import hdiff_fixed_point_ref, hdiff_ref, hdiff_simple_ref
