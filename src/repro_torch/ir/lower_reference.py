"""Reference lowering: eager PyTorch execution of an IR program.

The counterpart of ``repro/ir/lower_reference.py``, with the two modes of
``repro_torch.core.compound``'s reference policies:

  * ``fused``  — the whole DAG in one eager call (:func:`apply_program`);
    PyTorch runs each op as its own elementwise kernel, so intermediates
    still pass through device memory — the eager counterpart of the JAX
    package's jitted function, not a fused kernel.
  * ``staged`` — every op is materialised as its own tensor, with a device
    synchronisation after each op on the card (the single-AIE / load-store
    baseline of Fig. 9).

Both run where the input tensors live. Every lowered callable is wrapped
in :func:`repro_torch.obs.metrics.instrument_call` under
``ir.lower_reference.<program>.<mode>``, the JAX package's name: a
per-call timer and ``.calls`` counter when metrics are on, a straight
call-through when they are off.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.ir.evaluate import apply_program, embed_interior, op_views, thread_chain
from repro_torch.ir.graph import StencilProgram
from repro_torch.obs import metrics

Tensor = torch.Tensor


def lower_reference(
    program: StencilProgram, *, mode: str = "fused"
) -> Callable[[Tensor | Mapping[str, Tensor]], Tensor]:
    name = f"ir.lower_reference.{program.name}.{mode}"
    if mode == "fused":
        return metrics.instrument_call(lambda x: apply_program(program, x), name)
    if mode == "staged":
        if program.steps == 1:
            return metrics.instrument_call(_lower_staged(program), name)
        runs = [(p, _lower_staged(p)) for p in program.chain]
        return metrics.instrument_call(lambda x: thread_chain(program, x, runs), name)
    raise ValueError(f"unknown mode {mode!r} (want 'fused' or 'staged')")


def _lower_staged(program: StencilProgram):
    nd = program.ndim
    margins = program.margins()

    def stage(op, arrays):
        # Recover the source-grid extent from the first read's array (each
        # field is stored inset by its own margins).
        lo0, hi0 = margins[op.reads[0].field]
        grid = tuple(arrays[0].shape[-nd + d] + lo0[d] + hi0[d] for d in range(nd))
        env = {read.field: arr for read, arr in zip(op.reads, arrays)}
        out = op.compute(*op_views(op, env, margins, grid, nd))
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    def run(x):
        if isinstance(x, Mapping):
            env = dict(x)
        else:
            if len(program.inputs) != 1:
                raise ValueError(
                    f"program {program.name!r} has inputs {program.inputs}; "
                    "pass a mapping"
                )
            env = {program.inputs[0]: x}
        for op in program.ops:
            env[op.name] = stage(op, tuple(env[r.field] for r in op.reads))
        out = {
            f: embed_interior(program, env[f], env[op_name], output=f)
            for f, op_name in program.outputs.items()
        }
        if len(out) > 1:
            return out
        return out[program.passthrough]

    return run
