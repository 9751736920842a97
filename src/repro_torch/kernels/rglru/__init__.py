"""RG-LRU: the hand-written scan kernel K6, its entry point and its plain versions."""
from repro_torch.kernels.rglru.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru.ops import RGLRUScan, rglru_backward, rglru_reverse, rglru_scan
from repro_torch.kernels.rglru.ref import rglru_reverse_ref, rglru_scan_ref, rglru_seq_ref
