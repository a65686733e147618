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


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(n, dtype):
    """Shared memory one block of these kernels needs (mirrors the CUDA source)."""
    ld = n | 1
    return torch.finfo(dtype).bits // 8 * (n * ld + 2 * n)


def check_args(name, a, *vecs, smem=smem_bytes, dtypes=DTYPES):
    """Raise unless ``a`` (B, n, n) and each of ``vecs`` (B, n) are contiguous
    CUDA tensors on one device, all of one dtype out of ``dtypes``, and the
    ``smem(n, dtype)`` bytes of shared memory the kernel needs fit one block."""
    ts = (a, *vecs)
    if a.device.type != "cuda" or any(t.device != a.device for t in vecs):
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if a.dtype not in dtypes or any(t.dtype != a.dtype for t in vecs):
        raise TypeError(f"{name}: expected one dtype out of {list(dtypes)}, got "
                        f"{[t.dtype for t in ts]}")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or any(t.shape != a.shape[:2] for t in vecs):
        raise ValueError(f"{name}: expected a (B, n, n) and vectors (B, n), got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    n = a.shape[1]
    if smem(n, a.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: n={n} in {a.dtype} needs {smem(n, a.dtype)} bytes "
                         f"of shared memory, more than one block has ({MAX_SMEM_BYTES})")


def on_cpu(name, a, *vecs, smem=smem_bytes, dtypes=DTYPES):
    """True when every tensor lies on the CPU, where the wrapper runs its
    plain version; otherwise checks that the kernel takes them and returns
    False (a CUDA tensor never reaches a plain version)."""
    if a.device.type == "cpu" and all(t.device.type == "cpu" for t in vecs):
        return True
    check_args(name, a, *vecs, smem=smem, dtypes=dtypes)
    return False


def _launch(name, *tensors, batch, n, device):
    if batch == 0:
        return
    _build.launch(name, tensors, (batch, n), device)
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
    _launch(name, a, b, x, l, batch=a.shape[0], n=a.shape[1], device=a.device)
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
    _launch(name, a, b, x, batch=a.shape[0], n=a.shape[1], device=a.device)
    return x


def chol_factor_lane(a):
    """l = chol(a) for a batch of SPD matrices; l's upper triangle holds
    leftover input, and ``a`` is left as it was."""
    name = "chol_factor_lane"
    if on_cpu(name, a):
        return chol_factor_lane_plain(a)
    l = torch.empty_like(a)
    _launch(name, a, l, batch=a.shape[0], n=a.shape[1], device=a.device)
    return l
