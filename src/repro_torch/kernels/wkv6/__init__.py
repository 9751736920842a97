"""RWKV-6 WKV: the hand-written kernel K7 and its backward, their entry point and
their plain versions."""
from repro_torch.kernels.wkv6.kernel import wkv6_bwd_cuda, wkv6_cuda
from repro_torch.kernels.wkv6.ops import WKV6, wkv6
from repro_torch.kernels.wkv6.ref import (wkv6_backward_plain, wkv6_chunked_ref, wkv6_plain,
                                          wkv6_ref)
