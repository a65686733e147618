"""Fused fixed-count Mehrotra steps for a batch of box QPs, and the step itself.

Counterpart of ``hybdrt_tpu/ops/pallas_ip_lane.py::ip_steps_lane``, written in
CUDA for Hopper in ``hybdrt_torch/csrc/ip_lane.cu``:

- ``ip_steps_lane(P, q, lb, x0, s0, z0, n_steps) -> (x, s, z)``: ``n_steps``
  Mehrotra predictor-corrector steps per lane with P kept on chip, no
  convergence test, and a latched per-lane freeze: a lane whose new x or z
  has a non-finite entry keeps its last iterate for every remaining step.

P is (B, n, n), already Jacobi-equilibrated and symmetrized (``qp.py``), and
q, lb, x0, s0, z0 are (B, n), contiguous, float32 or float64. The step rule
is that of ``hybdrt_tpu/ops/qp.py::_ip_steps_single``, whose corrector step
``min(1, 0.99 min(1, ratio))`` never exceeds 0.99; the TPU kernel departs
from it (``pallas_ip_lane.py:133-134``, ROADMAP Queue 3) and the fit does
not follow that departure. The same CUDA kernel with the TPU kernel's rule
(``full_step``) is the experiment ``hybdrt_torch/experiments/ip_loop.py``.

Given CPU tensors the wrapper runs ``ip_steps_lane_plain``, a loop of
``mehrotra_step`` on the plain Cholesky versions of ``ops/chol_lane.py``.
Given CUDA tensors it launches its kernel or raises, and adds one to
``LAUNCHES["ip_steps_lane"]`` per launch and nowhere else.

``mehrotra_step`` is also the step of the QP's own ``while`` loop
(``ops/qp.py``), there on the dispatching Cholesky wrappers.
"""
import torch

from ..csrc import build as _build
from . import chol_lane

LAUNCHES = {"ip_steps_lane": 0}


def reset_launch_counts():
    LAUNCHES["ip_steps_lane"] = 0


# Tiles of H a thread holds (csrc/ip_lane.cu instantiates 1 .. kMaxTPT<T>,
# which this mirrors): a block holds H's lower tiles on the fewest whole warps
# at this many tiles a thread, so at most REG_THREADS_MAX times as many
# tiles, n <= 216 in float32 and 152 in float64. At n = 93 and 94: 96
# threads of 4 tiles in float32 (162 registers, no spill), 160 of 2 in
# float64 (168 registers, 16 bytes of spill).
MAX_TILES_PER_THREAD = {torch.float32: 4, torch.float64: 2}


def smem_bytes(n, dtype):
    """Shared memory one block of the kernel needs (mirrors ``smem_bytes`` in
    ``csrc/ip_lane.cu``): two panel buffers of np x 4 (np = n rounded up to
    4) and 13 vectors."""
    np_ = chol_lane.TILE * -(-n // chol_lane.TILE)
    return torch.finfo(dtype).bits // 8 * (2 * chol_lane.TILE * np_ + 13 * n)


def admitted(n, dtype):
    """Whether the kernel takes lanes of size n in ``dtype`` (the rule
    ``check_args`` applies): H's lower tiles fit ``chol_lane.
    REG_THREADS_MAX`` threads at ``MAX_TILES_PER_THREAD[dtype]`` tiles a
    thread."""
    return chol_lane.admitted(n, dtype, smem_bytes, MAX_TILES_PER_THREAD)


def check_args(name, P, *vecs, dtypes=chol_lane.DTYPES):
    """``chol_lane.check_args`` with this kernel's rule for n."""
    chol_lane.check_args(name, P, *vecs, smem=smem_bytes, dtypes=dtypes,
                         tiles=MAX_TILES_PER_THREAD)


def on_cpu(name, P, *vecs, dtypes=chol_lane.DTYPES):
    """``chol_lane.on_cpu`` with this kernel's rule for n."""
    return chol_lane.on_cpu(name, P, *vecs, smem=smem_bytes, dtypes=dtypes,
                            tiles=MAX_TILES_PER_THREAD)


def geometry(n, dtype):
    """(threads, tiles a thread, shared bytes) of a block for n: H's lower
    tiles on the fewest whole warps (at most ``chol_lane.REG_THREADS_MAX``
    threads) that hold them at ``MAX_TILES_PER_THREAD[dtype]`` tiles a
    thread, as ``chol_lane.reg_geometry`` does."""
    threads, tpt, _ = chol_lane.reg_geometry(n, dtype, MAX_TILES_PER_THREAD[dtype])
    return threads, tpt, smem_bytes(n, dtype)


def _mv(P, x):
    return torch.matmul(P, x.unsqueeze(-1)).squeeze(-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _add_diag(P, d):
    out = P.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(d)
    return out


def _min_ratio(v, dv):
    """Fraction-to-boundary ratio per lane: the largest alpha with
    v + alpha dv >= 0, not capped (inf where no dv is negative)."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), torch.inf)
    return torch.amin(ratio, dim=-1)


def _max_step(v, dv):
    """Largest alpha in (0, 1] with v + alpha dv >= 0, per lane."""
    return torch.clamp(_min_ratio(v, dv), max=1.0)


def mehrotra_step(P, q, lb, x, s, z, mu_floor, factor_solve, solve_factored,
                  full_step=False):
    """One Mehrotra predictor-corrector step on every lane
    (``hybdrt_tpu/ops/qp.py:311-346``, ``:162-185``).

    ``mu_floor`` bounds the denominator of sigma (1e-300 in the QP's loop,
    1e-30 in the fused steps). ``factor_solve(a, b) -> (x, l)`` and
    ``solve_factored(l, b)`` are the Cholesky routines to use. The
    corrector's step is min(1, 0.99 min(1, ratio)), or with ``full_step``
    the TPU kernels' min(1, 0.99 ratio) (``pallas_ip_lane.py:133-134``,
    ``experiments/pallas_ip_loop.py:136-137``); both keep a NaN ratio NaN.
    Returns ``(x_new, s_new, z_new, bad)``, with ``bad`` (B,) true where
    x_new or z_new has a non-finite entry."""
    n = q.shape[-1]
    d = z / s
    r_d = _mv(P, x) + q - z
    r_p = s - (x - lb)
    mu = _dot(s, z) / n
    H = _add_diag(P, d)

    # Predictor (affine scaling) step; the factor is reused below
    rhs_aff = -r_d - z + d * r_p
    dx_aff, l_f = factor_solve(H, rhs_aff)
    ds_aff = dx_aff - r_p
    dz_aff = -z - d * ds_aff
    a_p = _max_step(s, ds_aff)[:, None]
    a_d = _max_step(z, dz_aff)[:, None]
    mu_aff = _dot(s + a_p * ds_aff, z + a_d * dz_aff) / n
    sigma = torch.clamp((mu_aff / torch.clamp(mu, min=mu_floor)) ** 3, 0.0, 1.0)

    # Corrector step
    r_c = s * z + ds_aff * dz_aff - (sigma * mu)[:, None]
    rhs = -r_d - r_c / s + d * r_p
    dx = solve_factored(l_f, rhs)
    ds = dx - r_p
    dz = -r_c / s - d * ds

    ratio = _min_ratio if full_step else _max_step
    a_p = torch.clamp(0.99 * ratio(s, ds), max=1.0)[:, None]
    a_d = torch.clamp(0.99 * ratio(z, dz), max=1.0)[:, None]
    tiny = 1e-30 if q.dtype == torch.float64 else 1e-25
    x_new = x + a_p * dx
    s_new = torch.clamp(s + a_p * ds, min=tiny)
    z_new = torch.clamp(z + a_d * dz, min=tiny)
    bad = ~(torch.isfinite(x_new).all(-1) & torch.isfinite(z_new).all(-1))
    return x_new, s_new, z_new, bad


def ip_steps_lane_plain(P, q, lb, x0, s0, z0, n_steps, full_step=False,
                        factor_solve=chol_lane.chol_factor_solve_lane_plain,
                        solve_factored=chol_lane.chol_solve_factored_lane_plain):
    """The kernel's steps in plain PyTorch; ``full_step`` as in
    ``mehrotra_step``. ``factor_solve`` and ``solve_factored`` are the
    Cholesky routines (the plain ones by default; ``ops/qp.py`` passes its
    dispatching ones for n above ``admitted``, the JAX package's vmapped
    ``_ip_steps_single``, ``hybdrt_tpu/ops/qp.py:218``)."""
    x, s, z = x0, s0, z0
    frozen = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for _ in range(n_steps):
        x_new, s_new, z_new, bad = mehrotra_step(
            P, q, lb, x, s, z, 1e-30, factor_solve, solve_factored, full_step)
        frozen = frozen | bad
        keep = frozen[:, None]
        x = torch.where(keep, x, x_new)
        s = torch.where(keep, s, s_new)
        z = torch.where(keep, z, z_new)
    return x, s, z


def ip_steps_lane(P, q, lb, x0, s0, z0, n_steps):
    """``n_steps`` Mehrotra steps on every lane from (x0, s0, z0) -> (x, s, z)."""
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"ip_steps_lane: n_steps={n_steps} must be >= 0")
    vecs = (q, lb, x0, s0, z0)
    if on_cpu("ip_steps_lane", P, *vecs):
        return ip_steps_lane_plain(P, q, lb, x0, s0, z0, n_steps)
    x, s, z = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    bsz, n = q.shape
    if bsz:
        _build.launch("ip_steps_lane", (P, *vecs, x, s, z),
                      (bsz, n, n_steps, geometry(n, P.dtype)[0]), P.device)
        LAUNCHES["ip_steps_lane"] += 1
    return x, s, z
