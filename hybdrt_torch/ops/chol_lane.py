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

All but ``chol_solve_factored_lane`` hold the lower triangle in registers,
in 4x4 tiles spread over the block's threads (``csrc/lane_regs.cuh``);
``reg_geometry`` picks the threads from n, as the CUDA launcher expects.
``chol_solve_factored_lane`` substitutes with one warp against the factor in
shared memory. The factor's update order is fixed, so the first and the last
give bitwise the same L, and the first and the third bitwise the same x.

``a``/``l`` are (B, n, n) and ``b``/``x`` are (B, n), contiguous, float32 or
float64. Only the lower triangle of a returned factor is valid, and a
non-positive pivot yields NaN.

A wrapper given CPU tensors runs the plain PyTorch version
(``torch.linalg.cholesky_ex`` and triangular solves, with the NaN contract
applied from ``info``). Given CUDA tensors it launches its kernel or raises.
Each wrapper adds one to ``LAUNCHES[name]`` for every kernel launch and
nowhere else.
"""
import torch

from ..csrc import build as _build

LAUNCHES = {"chol_factor_solve_lane": 0, "chol_solve_factored_lane": 0,
            "chol_solve_lane": 0, "chol_factor_lane": 0}

# Shared memory one block may use on sm_90 (dynamic, after opting in)
MAX_SMEM_BYTES = 232448
DTYPES = (torch.float32, torch.float64)


# The register-tiled kernels (mirrors csrc/lane_regs.cuh and chol_lane.cu):
# 4x4 tiles of the lower triangle, at most REG_THREADS_MAX threads a block,
# TILES_PER_THREAD tiles a thread where that many threads suffice, else up to
# MAX_TILES_PER_THREAD (the launcher's instantiations). At n = 93 and 94
# these are 64 threads of 5 tiles in float32 and 160 of 2 in float64, where
# ptxas reports no spill (3 float64 tiles a thread spill).
TILE = 4
REG_THREADS_MAX = 384
TILES_PER_THREAD = {torch.float32: 5, torch.float64: 2}
MAX_TILES_PER_THREAD = {torch.float32: 6, torch.float64: 3}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(n, dtype):
    """Shared memory one block of these kernels needs (mirrors the CUDA source)."""
    ld = n | 1
    return torch.finfo(dtype).bits // 8 * (n * ld + 2 * n)


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


def lower_tiles(n):
    """The 4x4 tiles of an (n, n) lower triangle: ceil(n/4) (ceil(n/4) + 1) / 2."""
    nt = -(-n // TILE)
    return nt * (nt + 1) // 2


def admitted(n, dtype, smem=smem_bytes, tiles=None):
    """Whether the kernels take matrices of size n in ``dtype``: those whose
    ``smem(n, dtype)`` bytes fit one block's shared memory and, for a kernel
    that holds the lower triangle in registers at most ``tiles[dtype]`` tiles
    a thread, whose tiles fit REG_THREADS_MAX threads."""
    return smem(n, dtype) <= MAX_SMEM_BYTES and (
        tiles is None or lower_tiles(n) <= REG_THREADS_MAX * tiles[dtype])


def check_args(name, a, *vecs, smem=smem_bytes, dtypes=DTYPES, tiles=None):
    """Raise unless ``a`` (B, n, n) and each of ``vecs`` (B, n) are all of one
    dtype out of ``dtypes``, the kernel takes their n (``admitted``: the
    ``smem(n, dtype)`` bytes of shared memory it needs fit one block, and the
    lower tiles fit its registers where ``tiles`` is given), and they are
    contiguous CUDA tensors on one device."""
    ts = (a, *vecs)
    if a.dtype not in dtypes or any(t.dtype != a.dtype for t in vecs):
        raise TypeError(f"{name}: expected one dtype out of {list(dtypes)}, got "
                        f"{[t.dtype for t in ts]}")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or any(t.shape != a.shape[:2] for t in vecs):
        raise ValueError(f"{name}: expected a (B, n, n) and vectors (B, n), got "
                         f"{[tuple(t.shape) for t in ts]}")
    n = a.shape[1]
    if not admitted(n, a.dtype, smem):
        raise ValueError(f"{name}: n={n} in {a.dtype} needs {smem(n, a.dtype)} bytes "
                         f"of shared memory, more than one block has ({MAX_SMEM_BYTES})")
    if not admitted(n, a.dtype, smem, tiles):
        raise ValueError(f"{name}: n={n} has {lower_tiles(n)} lower tiles, more than "
                         f"{REG_THREADS_MAX} threads hold at {tiles[a.dtype]} a thread in "
                         f"{a.dtype}")
    if a.device.type != "cuda" or any(t.device != a.device for t in vecs):
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")


def on_cpu(name, a, *vecs, smem=smem_bytes, dtypes=DTYPES, tiles=None):
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
    _launch(name, l, b, x, batch=l.shape[0], n=l.shape[1], device=l.device)
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
