"""Moving state between the JAX package and the port.

A stencil system has no weights: its "parameters" are the program (with
its coefficients baked into the graph — identity is
``StencilProgram.fingerprint()``, equal in both packages for the same
program) and the field state. The JAX package takes a bare array or a
``{field: array}`` mapping; :func:`fields_from_numpy` turns the same host
arrays into the port's tensors on a device, and :func:`to_numpy` turns a
result (bare tensor or ``{field: tensor}``) back into numpy. Nothing here
imports JAX: arrays cross as numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ir.evaluate import resolve_field_arrays
from repro_torch.ir.graph import StencilProgram


def fields_from_numpy(program: StencilProgram, arrays, device=None):
    """``arrays`` (a bare array or a ``{field: array}`` mapping covering
    every input of ``program``, all on one grid) as tensors on ``device``
    (``None`` means ``"cuda"``), in the same form: a bare tensor for a bare
    array, else ``{field: tensor}`` in ``program.inputs`` order."""
    dev = resolve_device(device)
    host = resolve_field_arrays(program, arrays)
    tensors = [torch.from_numpy(np.array(a)).to(dev) for a in host]
    if isinstance(arrays, Mapping):
        return dict(zip(program.inputs, tensors))
    return tensors[0]


def to_numpy(result):
    """A lowered result as numpy: a bare ndarray, or ``{field: ndarray}``.
    bfloat16 comes back as float32 (exactly): numpy has no bfloat16."""
    if isinstance(result, Mapping):
        return {f: to_numpy(a) for f, a in result.items()}
    if result.dtype == torch.bfloat16:
        result = result.to(torch.float32)
    return result.detach().cpu().numpy()
