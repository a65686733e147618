"""Column-loop factor and solve, several matrices per block: the port of
``experiments/pallas_chol_column.py::chol_solve_batched``.

``chol_solve_batched(a, b, block_batch=None) -> x`` solves a x = b by an
unblocked right-looking Cholesky column loop and both substitutions, one
warp per matrix and ``block_batch`` matrices per thread block, with no
block barrier (CUDA kernel ``warp_solve_kernel`` in
``hybdrt_torch/csrc/chol_layouts.cu``).

Its contract is the TPU experiment's, not the lane kernels': the pivot is a
plain rsqrt, ``where(ajj > 0, rsqrt(max(ajj, 1e-30)), 0)``
(``pallas_chol_column.py:73``), so a non-positive pivot gives a zero column
and no update, and the substitutions divide by ``where(ljj != 0, ljj, 1)``
(``:89``, ``:102``). A failed lane returns finite numbers: x = b where every
pivot fails. ``torch.linalg.cholesky_ex`` would give NaN there, so the plain
version is its own column loop. ``block_batch`` changes no result; shared
memory bounds it (6 matrices of n = 93).

``a`` is (B, n, n) and ``b`` is (B, n), contiguous float32. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises, and each
launch adds one to ``LAUNCHES``.
"""
import torch

from ..csrc import build as _build
from ..ops import chol_lane

NAME = "chol_solve_batched"
LAUNCHES = {NAME: 0}
DTYPES = (torch.float32,)
# The TPU kernel's tile of matrices, and the most warps one block takes
DEFAULT_BLOCK_BATCH, MAX_BLOCK_BATCH = 8, 32


def reset_launch_counts():
    LAUNCHES[NAME] = 0


def smem_bytes(n, block_batch):
    """Shared memory of one block (mirrors the CUDA source): per matrix, the
    matrix at row stride n | 1 and its right-hand side."""
    return 4 * block_batch * (n * (n | 1) + n)


def block_batch_for(n, block_batch=None):
    """The matrices per block: ``block_batch`` if its shared memory fits one
    block, else ValueError; None takes the most that fit, at most the TPU
    kernel's 8."""
    if block_batch is None:
        fits = chol_lane.MAX_SMEM_BYTES // smem_bytes(n, 1)
        block_batch = min(DEFAULT_BLOCK_BATCH, fits)
    if not 1 <= block_batch <= MAX_BLOCK_BATCH:
        raise ValueError(f"block_batch={block_batch} outside 1..{MAX_BLOCK_BATCH}")
    if smem_bytes(n, block_batch) > chol_lane.MAX_SMEM_BYTES:
        raise ValueError(f"block_batch={block_batch} at n={n} needs "
                         f"{smem_bytes(n, block_batch)} bytes of shared memory, more than "
                         f"one block has ({chol_lane.MAX_SMEM_BYTES})")
    return block_batch


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------
def factor_zero_pivot_plain(a):
    """The lower factor of the column loop, a zero column where the pivot
    is not positive (the rest of the matrix then goes on un-updated)."""
    w = a.clone()
    l = torch.zeros_like(a)
    for j in range(a.shape[-1]):
        col = w[:, j:, j]
        ajj = col[:, :1]
        inv = torch.where(ajj > 0, torch.rsqrt(ajj.clamp_min(1e-30)), torch.zeros_like(ajj))
        lcol = col * inv
        l[:, j:, j] = lcol
        u = lcol[:, 1:]
        w[:, j + 1:, j + 1:] -= u[:, :, None] * u[:, None, :]
    return l


def solve_guarded_plain(l, b):
    """(L L^T) x = b from the lower triangle of l, dividing by 1 where a
    diagonal entry is 0."""
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    g = torch.where(d != 0, d, torch.ones_like(d))
    x = b.clone()
    n = b.shape[-1]
    for j in range(n):
        x[:, j] /= g[:, j]
        x[:, j + 1:] -= x[:, j:j + 1] * l[:, j + 1:, j]
    for j in reversed(range(n)):
        x[:, j] /= g[:, j]
        x[:, :j] -= l[:, j, :j] * x[:, j:j + 1]
    return x


def chol_solve_batched_plain(a, b):
    return solve_guarded_plain(factor_zero_pivot_plain(a), b)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------
def launch_warp_solve(name, launches, a, b, ints):
    """Launch ``name`` on (a, b) with the kernel's extra ``ints``, counting
    the launch in ``launches``; returns x."""
    x = torch.empty_like(b)
    if a.shape[0]:
        _build.launch(name, (a, b, x), (a.shape[0], a.shape[1], *ints), a.device)
        launches[name] += 1
    return x


def chol_solve_batched(a, b, block_batch=None):
    """x = a^-1 b by the column loop, ``block_batch`` matrices per block."""
    block_batch = block_batch_for(a.shape[-1], block_batch)
    if chol_lane.on_cpu(NAME, a, b, smem=lambda n, dt: smem_bytes(n, block_batch),
                        dtypes=DTYPES, tiles=None):
        return chol_solve_batched_plain(a, b)
    return launch_warp_solve(NAME, LAUNCHES, a, b, (block_batch,))
