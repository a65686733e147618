"""Panel-blocked column loop and solve, several matrices per block: the port
of ``experiments/pallas_chol_blocked.py::chol_solve_blocked``.

``chol_solve_blocked(a, b, block_batch=None, nb=16) -> x`` computes what
``chol_column.chol_solve_batched`` computes, under the same contract (plain
rsqrt, a zero column on a non-positive pivot, the division guard), with the
factor in panels of ``nb`` columns: each panel is factored column by column,
then its rank-``nb`` term leaves the trailing block as one product
``A22 -= U U^T``, in 4 x 4 register tiles (CUDA kernel
``warp_solve_kernel`` with ``nb > 0`` in ``hybdrt_torch/csrc/chol_layouts.cu``).
``nb`` need not divide n: the last panel is ragged (the TPU padded n to 128).
``nb`` and ``block_batch`` change no result, so the plain version is the
column loop's.

``a`` is (B, n, n) and ``b`` is (B, n), contiguous float32. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises, and each
launch adds one to ``LAUNCHES``.
"""
from ..ops import chol_lane
from .chol_column import (DTYPES, block_batch_for, chol_solve_batched_plain,
                          launch_warp_solve, smem_bytes)

NAME = "chol_solve_blocked"
LAUNCHES = {NAME: 0}

chol_solve_blocked_plain = chol_solve_batched_plain


def reset_launch_counts():
    LAUNCHES[NAME] = 0


def chol_solve_blocked(a, b, block_batch=None, nb=16):
    """x = a^-1 b by the column loop in panels of ``nb`` columns,
    ``block_batch`` matrices per block."""
    if nb < 1:
        raise ValueError(f"{NAME}: nb={nb} must be positive")
    block_batch = block_batch_for(a.shape[-1], block_batch)
    if chol_lane.on_cpu(NAME, a, b, smem=lambda n, dt: smem_bytes(n, block_batch),
                        dtypes=DTYPES, tiles=None):
        return chol_solve_blocked_plain(a, b)
    return launch_warp_solve(NAME, LAUNCHES, a, b, (block_batch, nb))
