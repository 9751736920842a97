"""K2's compulsory work, one output: one call of the IR compiler's fused
kernel for ``repeat(hdiff_program(), sweeps)`` (``ir.lower_cuda``, or
``ir.lower_batched`` with the members folded into depth) over a
``(depth, rows, cols)`` float32 state.

The input read once and the output written once, the sweeps between on
chip, and K1's 22 operations a point and sweep: the work of K1's call of
``sweeps`` sweeps (``work/k1.py``)."""

from portbench.work.k1 import least_s, per_call  # noqa: F401
