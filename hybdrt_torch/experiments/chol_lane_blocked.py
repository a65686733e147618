"""Panel-blocked factor and solve: the port of
``experiments/pallas_chol_lane_blocked.py::chol_factor_solve_lane_blocked``.

``chol_factor_solve_lane_blocked(a, b, kb=8) -> (x, l)`` computes what
``chol_factor_solve_lane`` computes, under its contract (refined rsqrt, NaN
from a non-positive pivot on, only the lower triangle of ``l`` valid), with
the factor blocked in panels of ``kb`` columns: the trailing block is
updated once per panel instead of once per column (CUDA kernel
``factor_solve_blocked_kernel`` in ``hybdrt_torch/csrc/chol_layouts.cu``).
``kb`` changes the order of the updates and not the function, so the plain
version is the lane kernel's.

``a`` is (B, n, n) and ``b`` is (B, n), contiguous float32. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises, and each
launch adds one to ``LAUNCHES``.
"""
import torch

from ..csrc import build as _build
from ..ops import chol_lane

NAME = "chol_factor_solve_lane_blocked"
LAUNCHES = {NAME: 0}
# The diagonal block of a panel is factored by one warp, a lane per row
MAX_PANEL = 32
DTYPES = (torch.float32,)


def reset_launch_counts():
    LAUNCHES[NAME] = 0


def smem_bytes(n, dtype=torch.float32):
    """Shared memory of one block (mirrors the CUDA source): the matrix, the
    right-hand side and a panel's inverse pivots."""
    return 4 * (n * (n | 1) + n + MAX_PANEL)


chol_factor_solve_lane_blocked_plain = chol_lane.chol_factor_solve_lane_plain


def chol_factor_solve_lane_blocked(a, b, kb=8):
    """(x, l) = (a^-1 b, chol(a)) with the factor in panels of ``kb``
    columns; l's upper triangle holds leftover input."""
    if not 1 <= kb <= MAX_PANEL:
        raise ValueError(f"{NAME}: kb={kb} outside 1..{MAX_PANEL}")
    if chol_lane.on_cpu(NAME, a, b, smem=smem_bytes, dtypes=DTYPES):
        return chol_factor_solve_lane_blocked_plain(a, b)
    x = torch.empty_like(b)
    l = torch.empty_like(a)
    if a.shape[0]:
        _build.launch(NAME, (a, b, x, l), (a.shape[0], a.shape[1], kb), a.device)
        LAUNCHES[NAME] += 1
    return x, l
