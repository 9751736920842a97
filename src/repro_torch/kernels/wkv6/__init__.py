"""RWKV-6 WKV: the hand-written kernel K7, its entry point and its plain versions."""
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_plain, wkv6_ref
