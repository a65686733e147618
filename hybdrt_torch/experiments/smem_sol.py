"""Speed-of-light probe of the lane factor: the port of
``experiments/vmem_sol.py::main.sol``.

``smem_sol(a) -> o`` runs the access pattern of the shared-memory column
factor that the lane kernels ran before their register-tiled design
(``hybdrt_torch/csrc/lane_regs.cuh``) with its arithmetic taken out: the same
grid, block, shared memory, column loop and two block barriers per column,
the same elements touched (column j from the diagonal down, then the
trailing lower triangle), each only scaled by ``SCALE`` (CUDA kernel
``sol_kernel`` in ``hybdrt_torch/csrc/chol_layouts.cu``). Element (r, c) of
the lower triangle comes out scaled by ``SCALE ** (c + 1)``; the upper
triangle is left as the input. The TPU probe (``vmem_sol.py:53-60``) also
scaled the upper part of each trailing block, because the TPU factor updated
it; the port's factor updates the lower triangle only, and so does its probe.

``sol_ratios`` times the probe against ``chol_factor_lane`` and
``chol_factor_solve_lane``: t_probe / t_factor is the share of the factor's
time that its access pattern and barriers alone take.

``a`` is (B, n, n), contiguous float32. A CPU tensor runs the plain version;
a CUDA tensor launches the kernel or raises, and each launch adds one to
``LAUNCHES``.
"""
import torch

from ..csrc import build as _build
from ..ops import chol_lane
from ..utils.probe import in_turns

NAME = "smem_sol"
LAUNCHES = {NAME: 0}
DTYPES = (torch.float32,)
SCALE = 0.999


def reset_launch_counts():
    LAUNCHES[NAME] = 0


def smem_sol_plain(a):
    """The probe's column loop on the lower triangle."""
    o = a.clone()
    n = a.shape[-1]
    low = torch.ones(n, n, dtype=torch.bool, device=a.device).tril()
    for j in range(n):
        o[:, j:, j] *= SCALE
        blk = o[:, j + 1:, j + 1:]
        o[:, j + 1:, j + 1:] = torch.where(low[j + 1:, j + 1:], blk * SCALE, blk)
    return o


def sol_weights(n, dtype=torch.float32, device="cpu"):
    """The probe's closed form: SCALE ** (c + 1) at (r, c), r >= c; 1 above."""
    c = torch.arange(n, dtype=torch.float64, device=device)
    w = torch.where(c[:, None] >= c[None, :], SCALE ** (c[None, :] + 1), 1.0)
    return w.to(dtype)


def sol_ops(b, n):
    """Multiplies of b probes: column j's n - j elements and its trailing
    lower triangle's (n - j - 1)(n - j)/2."""
    return b * sum((n - j) + (n - j - 1) * (n - j) // 2 for j in range(n))


def smem_sol(a):
    """The probe: a copy of ``a`` with each element the lane factor touches
    scaled by SCALE as often as the factor touches it."""
    if chol_lane.on_cpu(NAME, a, smem=chol_lane.smem_bytes, dtypes=DTYPES):
        return smem_sol_plain(a)
    o = torch.empty_like(a)
    if a.shape[0]:
        _build.launch(NAME, (a, o), (a.shape[0], a.shape[1]), a.device)
        LAUNCHES[NAME] += 1
    return o


def sol_ratios(a, b, reps=20):
    """Times the probe, ``chol_factor_lane`` and ``chol_factor_solve_lane``
    on the card in turns (probe, factor, factor-solve, then backwards; CUDA
    events, mean of ``reps`` after a warm-up). Returns ({name: [ms, ms]},
    {"chol_factor_lane": t_probe / t_factor, "chol_factor_solve_lane": ...}),
    the ratios from the mean of each pair."""
    fns = {NAME: lambda: smem_sol(a),
           "chol_factor_lane": lambda: chol_lane.chol_factor_lane(a),
           "chol_factor_solve_lane": lambda: chol_lane.chol_factor_solve_lane(a, b)}
    ms = in_turns(fns, reps)
    t_probe = sum(ms[NAME]) / 2
    return ms, {k: t_probe / (sum(ms[k]) / 2) for k in fns if k != NAME}
