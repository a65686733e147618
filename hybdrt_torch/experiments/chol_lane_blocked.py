"""Panel-blocked factor and solve: the port of
``experiments/pallas_chol_lane_blocked.py::chol_factor_solve_lane_blocked``.

``chol_factor_solve_lane_blocked(a, b, kb=8) -> (x, l)`` computes what
``chol_factor_solve_lane`` computes, under its contract (refined rsqrt, NaN
from a non-positive pivot on, only the lower triangle of ``l`` valid, the
upper one the input's), with the factor blocked in panels of ``kb`` columns:
the trailing block takes each panel's ``kb`` products at once, summed in a
register (CUDA kernel ``factor_solve_kb_kernel`` in
``hybdrt_torch/csrc/chol_layouts.cu``). The kernel runs
``chol_factor_solve_lane``'s register-tiled skeleton (its threads,
``chol_lane.reg_geometry``, and its tile rule for n) with two block barriers
per panel. ``kb`` changes the order of the updates and not the function, so
the plain version is the lane kernel's.

``a`` is (B, n, n) and ``b`` is (B, n), contiguous float32. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises, and each
launch adds one to ``LAUNCHES``.
"""
import torch

from ..csrc import build as _build
from ..ops import chol_lane

NAME = "chol_factor_solve_lane_blocked"
LAUNCHES = {NAME: 0}
# The widest panel the kernel takes
MAX_PANEL = 32
DTYPES = (torch.float32,)


def reset_launch_counts():
    LAUNCHES[NAME] = 0


def panel_stride(kb):
    """Row stride of a panel buffer in floats (mirrors the CUDA source): kb
    rounded up to 4, an odd count of 16-byte vectors."""
    return 4 * (-(-kb // 4) | 1)


def smem_bytes(n, kb=8):
    """Shared memory of one block (mirrors the CUDA source): two panel
    buffers of 4 ceil(n / 4) rows, w, and the stage of the strict upper
    triangle."""
    np_ = 4 * -(-n // 4)
    return 4 * (2 * panel_stride(kb) * np_ + np_ + n * (n - 1) // 2)


chol_factor_solve_lane_blocked_plain = chol_lane.chol_factor_solve_lane_plain


def chol_factor_solve_lane_blocked(a, b, kb=8):
    """(x, l) = (a^-1 b, chol(a)) with the factor in panels of ``kb``
    columns; l's upper triangle holds leftover input."""
    if not 1 <= kb <= MAX_PANEL:
        raise ValueError(f"{NAME}: kb={kb} outside 1..{MAX_PANEL}")
    if chol_lane.on_cpu(NAME, a, b, smem=lambda n, dt: smem_bytes(n, kb), dtypes=DTYPES):
        return chol_factor_solve_lane_blocked_plain(a, b)
    x = torch.empty_like(b)
    l = torch.empty_like(a)
    n = a.shape[1]
    if a.shape[0]:
        threads = chol_lane.reg_geometry(n, a.dtype)[0]
        _build.launch(NAME, (a, b, x, l), (a.shape[0], n, kb, threads), a.device)
        LAUNCHES[NAME] += 1
    return x, l
