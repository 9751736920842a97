"""The port's default-device rule.

Entry points that CREATE tensors take ``device=None``, which means the
card (``"cuda"``); without one they raise and name ``device="cpu"`` rather
than quietly running on the host. Entry points that TAKE tensors run where
the tensors live and never consult this rule.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and PyTorch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch defaults to the CUDA device, but torch.cuda.is_available() "
            'is False; pass device="cpu" to run the plain PyTorch path on the host'
        )
    return dev
