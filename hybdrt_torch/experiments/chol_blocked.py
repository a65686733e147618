"""Panel-blocked column loop and solve, several matrices per block: the port
of ``experiments/pallas_chol_blocked.py::chol_solve_blocked``.

``chol_solve_blocked(a, b, block_batch=None, nb=16) -> x`` computes what
``chol_column.chol_solve_batched`` computes, under the same contract (plain
rsqrt, a zero column on a non-positive pivot, the division guard), in the
TPU kernel's panel order: each element of a panel of ``nb`` columns first
loses, per earlier panel, that panel's products summed apart, then its own
panel's terms one at a time, then takes its column's scale. It is the
column solve's kernel in its panelled instantiation (CUDA kernel
``column_solve_kernel`` in ``hybdrt_torch/csrc/chol_layouts.cu``): one warp
per matrix on its padded packed lower triangle, each element's sums in
registers and the element written once, so its shared memory is the column
solve's (``smem_bytes``: 12 matrices of n = 93 fit one block, default the
TPU kernel's 8). ``nb`` need not divide n: the last panel is ragged (the TPU
padded n to 128); with one panel (``nb >= n``) x is the column solve's, bit
for bit. ``block_batch`` changes no bit of x and ``nb`` none beyond the
tolerance, so the plain version is the column loop's.

``a`` is (B, n, n) and ``b`` is (B, n), contiguous float32. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises, and each
launch adds one to ``LAUNCHES``.
"""
from ..ops import chol_lane
from . import chol_column
from .chol_column import DTYPES, chol_solve_batched_plain, launch_warp_solve

NAME = "chol_solve_blocked"
LAUNCHES = {NAME: 0}

chol_solve_blocked_plain = chol_solve_batched_plain


def reset_launch_counts():
    LAUNCHES[NAME] = 0


# One kernel with the column solve: its shared memory and block_batch rule
smem_bytes = chol_column.smem_bytes
block_batch_for = chol_column.block_batch_for


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
