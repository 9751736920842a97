"""Field statistics: the hand-written one-read kernel and its plain version."""
from repro_torch.kernels.stats.kernel import ACC_KEYS, field_stats_cuda, field_stats_plain
