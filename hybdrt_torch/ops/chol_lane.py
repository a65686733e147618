"""Batched SPD Cholesky factor/solve kernels and their plain versions.

Counterpart of ``hybdrt_tpu/ops/pallas_chol_lane.py``. Four kernels, written
in CUDA for Hopper in ``hybdrt_torch/csrc/chol_lane.cu``:

- ``chol_factor_solve_lane(a, b) -> (x, l)``: factor and one solve, returning
  the factor for reuse (the Mehrotra predictor);
- ``chol_solve_factored_lane(l, b) -> x``: both triangular solves against that
  factor (the Mehrotra corrector);
- ``chol_solve_lane(a, b) -> x``: factor and solve without returning the
  factor (the QP's cold start and active-set polish);
- ``chol_factor_lane(a) -> l``: the factor alone (the group resolve's
  block-Jacobi preconditioner, ``mapping/resolve.py``); ``a`` is not written.

The first, third and fourth hold the lower triangle in registers, in 4x4
tiles spread over the block's threads (``csrc/lane_regs.cuh``);
``reg_geometry`` picks the threads from n, as the CUDA launcher expects.
``chol_solve_factored_lane`` copies the factor's lower triangle, packed by
rows, into shared memory and substitutes with one warp, one matrix to a
block (``solve_geometry``). The factor's update order and the substitutions'
orders are fixed, so the first and the last give bitwise the same L, the
first and the third bitwise the same x, and the second, given the first's
L, bitwise the first's x.

``a``/``l`` are (B, n, n) and ``b``/``x`` are (B, n), contiguous, float32 or
float64. Only the lower triangle of a returned factor is valid, and a
non-positive pivot yields NaN.

A wrapper given CPU tensors runs the plain PyTorch version
(``torch.linalg.cholesky_ex`` and triangular solves, with the NaN contract
applied from ``info``). Given CUDA tensors it launches its kernel or raises.
Each wrapper adds one to ``LAUNCHES[name]`` for every kernel launch and
nowhere else.

Matrices above the tile rule (``admitted``) do not reach these wrappers:
``ops/qp.py`` factors them with the library route, and counts the box QPs
that took each route in ``QP_ROUTES`` (and the fused warm QPs above the
fused kernel's rule, which run its steps in plain PyTorch);
``reset_launch_counts`` zeroes both counters.
"""
import torch

from ..csrc import build as _build

LAUNCHES = {"chol_factor_solve_lane": 0, "chol_solve_factored_lane": 0,
            "chol_solve_lane": 0, "chol_factor_lane": 0}
# Box QPs (ops/qp.py::solve_qp_box) by route: "lane" through the wrappers
# below (the kernels on a GPU), "library" through ops/qp.py's library factor
# route (torch.linalg); "fused_plain" counts, besides, the QPs whose fused
# steps ran as a loop of plain Mehrotra steps (n above ip_lane.admitted)
QP_ROUTES = {"lane": 0, "library": 0, "fused_plain": 0}

# Shared memory one block may use on sm_90 (dynamic, after opting in)
MAX_SMEM_BYTES = 232448
DTYPES = (torch.float32, torch.float64)


# The register-tiled kernels (mirrors csrc/lane_regs.cuh and chol_lane.cu):
# 4x4 tiles of the lower triangle, at most REG_THREADS_MAX threads a block,
# TILES_PER_THREAD tiles a thread where that many threads suffice, else up to
# MAX_TILES_PER_THREAD (the launcher's instantiations). At n = 93 and 94
# these are 64 threads of 5 tiles in float32 and 160 of 2 in float64, where
# ptxas reports no spill (3 float64 tiles a thread spill). The four kernels
# take the n whose tiles fit REG_THREADS_MAX threads at
# MAX_TILES_PER_THREAD (``admitted``): n <= 268 in float32, 188 in float64.
TILE = 4
REG_THREADS_MAX = 384
TILES_PER_THREAD = {torch.float32: 5, torch.float64: 2}
MAX_TILES_PER_THREAD = {torch.float32: 6, torch.float64: 3}
# chol_solve_factored_lane: one warp a matrix and a matrix a block
# (chol_lane.cu's kSolveThreads)
SOLVE_THREADS = 32


def reset_launch_counts():
    for counts in (LAUNCHES, QP_ROUTES):
        for k in counts:
            counts[k] = 0


def reg_geometry(n, dtype, tiles_per_thread=None):
    """(threads, tiles a thread, shared bytes) of the register-tiled kernels
    for n: the fewest threads, in whole warps and at most REG_THREADS_MAX,
    that hold the ceil(n/4) * (ceil(n/4) + 1) / 2 lower tiles at
    ``tiles_per_thread`` (default ``TILES_PER_THREAD[dtype]``) tiles a thread
    where they can. The shared bytes are ``chol_factor_solve_lane``'s (two
    panel buffers of 4 * ceil(n/4) rows of 4, w, and the stage of the strict
    upper triangle); ``chol_factor_lane`` needs all but w,
    ``chol_solve_lane`` all but the stage."""
    per_thread = TILES_PER_THREAD[dtype] if tiles_per_thread is None else tiles_per_thread
    nt = -(-n // TILE)
    tiles = lower_tiles(n)
    threads = min(32 * -(-tiles // (32 * per_thread)), REG_THREADS_MAX)
    smem = torch.finfo(dtype).bits // 8 * (2 * TILE * TILE * nt + TILE * nt + n * (n - 1) // 2)
    return threads, -(-tiles // threads), smem


def solve_geometry(n, dtype):
    """(threads, shared bytes) of a ``chol_solve_factored_lane`` block for n,
    which the wrapper passes to the launcher and the launcher refuses unless
    they are ``kSolveThreads`` and ``solve_smem_bytes`` (csrc/chol_lane.cu):
    one warp, the packed lower triangle, n (n + 1) / 2 values, and w. At
    every n the four kernels admit it fits one block (at most 145 KB, at
    n = 268 in float32)."""
    return SOLVE_THREADS, torch.finfo(dtype).bits // 8 * (n * (n + 1) // 2 + n)


def lower_tiles(n):
    """The 4x4 tiles of an (n, n) lower triangle: ceil(n/4) (ceil(n/4) + 1) / 2."""
    nt = -(-n // TILE)
    return nt * (nt + 1) // 2


def admitted(n, dtype, smem=None, tiles=MAX_TILES_PER_THREAD):
    """Whether a kernel takes matrices of size n in ``dtype``: those whose
    ``smem(n, dtype)`` bytes, where ``smem`` is given, fit one block's shared
    memory and, where ``tiles`` is given, whose lower tiles fit
    REG_THREADS_MAX threads at ``tiles[dtype]`` tiles a thread. The defaults
    are the rule of this module's four kernels, whose shared memory never
    binds first."""
    return (smem is None or smem(n, dtype) <= MAX_SMEM_BYTES) and (
        tiles is None or lower_tiles(n) <= REG_THREADS_MAX * tiles[dtype])


def check_args(name, a, *vecs, smem=None, dtypes=DTYPES, tiles=MAX_TILES_PER_THREAD):
    """Raise unless ``a`` (B, n, n) and each of ``vecs`` (B, n) are all of one
    dtype out of ``dtypes``, the kernel takes their n (``admitted``: the
    ``smem(n, dtype)`` bytes of shared memory it needs fit one block where
    ``smem`` is given, and the lower tiles fit its registers where ``tiles``
    is given), and they are contiguous CUDA tensors on one device."""
    ts = (a, *vecs)
    if a.dtype not in dtypes or any(t.dtype != a.dtype for t in vecs):
        raise TypeError(f"{name}: expected one dtype out of {list(dtypes)}, got "
                        f"{[t.dtype for t in ts]}")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or any(t.shape != a.shape[:2] for t in vecs):
        raise ValueError(f"{name}: expected a (B, n, n) and vectors (B, n), got "
                         f"{[tuple(t.shape) for t in ts]}")
    n = a.shape[1]
    if not admitted(n, a.dtype, smem, None):
        raise ValueError(f"{name}: n={n} in {a.dtype} needs {smem(n, a.dtype)} bytes "
                         f"of shared memory, more than one block has ({MAX_SMEM_BYTES})")
    if not admitted(n, a.dtype, None, tiles):
        raise ValueError(f"{name}: n={n} has {lower_tiles(n)} lower tiles, more than "
                         f"{REG_THREADS_MAX} threads hold at {tiles[a.dtype]} a thread in "
                         f"{a.dtype}")
    if a.device.type != "cuda" or any(t.device != a.device for t in vecs):
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")


def on_cpu(name, a, *vecs, smem=None, dtypes=DTYPES, tiles=MAX_TILES_PER_THREAD):
    """True when every tensor lies on the CPU, where the wrapper runs its
    plain version; otherwise checks that the kernel takes them and returns
    False (a CUDA tensor never reaches a plain version)."""
    if a.device.type == "cpu" and all(t.device.type == "cpu" for t in vecs):
        return True
    check_args(name, a, *vecs, smem=smem, dtypes=dtypes, tiles=tiles)
    return False


def _launch(name, *tensors, batch, n, device, ints=()):
    if batch == 0:
        return
    _build.launch(name, tensors, (batch, n, *ints), device)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------
def _factor_plain(a):
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[:, None, None], torch.nan, l)


def chol_solve_factored_lane_plain(l, b):
    return torch.cholesky_solve(b.unsqueeze(-1), torch.tril(l)).squeeze(-1)


def chol_factor_solve_lane_plain(a, b):
    l = _factor_plain(a)
    return chol_solve_factored_lane_plain(l, b), l


def chol_solve_lane_plain(a, b):
    return chol_solve_factored_lane_plain(_factor_plain(a), b)


def chol_factor_lane_plain(a):
    return _factor_plain(a)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def chol_factor_solve_lane(a, b):
    """(x, l) = (a^-1 b, chol(a)); l's upper triangle holds leftover input."""
    name = "chol_factor_solve_lane"
    if on_cpu(name, a, b):
        return chol_factor_solve_lane_plain(a, b)
    x = torch.empty_like(b)
    l = torch.empty_like(a)
    n = a.shape[1]
    _launch(name, a, b, x, l, batch=a.shape[0], n=n, device=a.device,
            ints=reg_geometry(n, a.dtype)[:1])
    return x, l


def chol_solve_factored_lane(l, b):
    """x = (L L^T)^-1 b from the lower triangle of l."""
    name = "chol_solve_factored_lane"
    if on_cpu(name, l, b):
        return chol_solve_factored_lane_plain(l, b)
    x = torch.empty_like(b)
    n = l.shape[1]
    _launch(name, l, b, x, batch=l.shape[0], n=n, device=l.device,
            ints=solve_geometry(n, l.dtype))
    return x


def chol_solve_lane(a, b):
    """x = a^-1 b for a batch of SPD matrices."""
    name = "chol_solve_lane"
    if on_cpu(name, a, b):
        return chol_solve_lane_plain(a, b)
    x = torch.empty_like(b)
    n = a.shape[1]
    _launch(name, a, b, x, batch=a.shape[0], n=n, device=a.device,
            ints=reg_geometry(n, a.dtype)[:1])
    return x


def chol_factor_lane(a):
    """l = chol(a) for a batch of SPD matrices; l's upper triangle holds
    leftover input, and ``a`` is left as it was."""
    name = "chol_factor_lane"
    if on_cpu(name, a):
        return chol_factor_lane_plain(a)
    l = torch.empty_like(a)
    n = a.shape[1]
    _launch(name, a, l, batch=a.shape[0], n=n, device=a.device,
            ints=reg_geometry(n, a.dtype)[:1])
    return l
