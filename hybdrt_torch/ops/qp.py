"""Batched bound-constrained QP (counterpart of ``hybdrt_tpu/ops/qp.py``).

    min_x  1/2 x^T P x + q^T x    s.t.  x >= lb

for a batch of problems: P (B, n, n), q (B, n), lb (n,) or (B, n). Mehrotra
predictor-corrector interior point followed by an active-set polish, with
the batch dimension written out where the JAX package vmapped a
``while_loop``: every lane carries its own iteration count and ``done``
flag, and a lane whose loop condition is false is frozen by ``torch.where``,
so each lane stops at the iteration it stops at in JAX.

Each Mehrotra step (``ops/ip_lane.py::mehrotra_step``) factors
``P + diag(z/s)`` once and solves twice through the lane kernels of
``ops/chol_lane.py`` (CUDA on a GPU, plain PyTorch on the CPU), or, for n
above their tile rule, through the library route (``library_route``); the
cold start and the polish factor and solve in one call. With ``fused_steps`` a
fixed number of steps runs in one call of the fused kernel
``ops/ip_lane.py::ip_steps_lane`` instead of the loop, or, for n above that
kernel's rule (``fused_route``), as a loop of the same steps on the
dispatching Cholesky routines.
"""
from typing import NamedTuple

import torch

from . import chol_lane, ip_lane
from .ip_lane import _add_diag, _dot, _mv, ip_steps_lane, mehrotra_step


class QPResult(NamedTuple):
    x: torch.Tensor           # (B, n) primal solution
    z: torch.Tensor           # (B, n) dual for the bound constraints
    s: torch.Tensor           # (B, n) slacks x - lb
    gap: torch.Tensor         # (B,) final complementarity gap s.z
    iterations: torch.Tensor  # (B,) Mehrotra steps taken
    primal_objective: torch.Tensor


# ---------------------------------------------------------------------------
# SPD factor/solve dispatch (hybdrt_tpu/ops/qp.py:59-140). The JAX package
# reached the lane kernels through custom_vmap rules for batched float32 on
# the TPU and factored an unbatched problem with LAPACK
# (jnp.linalg.cholesky). Here every call is batched: a matrix the lane
# kernels take (chol_lane.admitted, the tile rule) goes through the
# chol_lane wrappers, which dispatch by device; a larger one (a dense
# resolve window, a single fit's wide basis) takes the library route,
# torch.linalg's factor and triangular solves on any device. The route is
# chosen by size alone, before anything runs, and a lane whose pivot is not
# positive gets NaN in its factor and x on both (hybdrt_tpu/ops/qp.py:344-349).
# ---------------------------------------------------------------------------
def library_route(n, dtype):
    """Whether (n, n) matrices of ``dtype`` take the library route: those
    above the lane kernels' tile rule."""
    return not chol_lane.admitted(n, dtype)


def fused_route(n, dtype):
    """How ``fused_steps`` run for (n, n) matrices of ``dtype``: "fused", one
    launch of ``ip_steps_lane``, for the n its kernel takes
    (``ip_lane.admitted``); "fused_plain", a loop of the same steps on
    ``spd_factor_solve`` and ``spd_solve_factored``, above it. Chosen by
    size alone, before anything runs."""
    return "fused" if ip_lane.admitted(n, dtype) else "fused_plain"


def _library_factor(a):
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[:, None, None], torch.nan, l)


def _library_solve_factored(l, b):
    y = torch.linalg.solve_triangular(l, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True).squeeze(-1)


def spd_factor_solve(a, b):
    """(x, l) = (a^-1 b, chol(a)): the Mehrotra predictor's factor is reused
    by the corrector."""
    if library_route(a.shape[-1], a.dtype):
        l = _library_factor(a)
        return _library_solve_factored(l, b), l
    return chol_lane.chol_factor_solve_lane(a.contiguous(), b.contiguous())


def spd_factor(a):
    """Lower Cholesky factor of each SPD matrix of the batch (lower triangle
    valid; ``a`` is not written)."""
    if library_route(a.shape[-1], a.dtype):
        return _library_factor(a)
    return chol_lane.chol_factor_lane(a.contiguous())


def spd_solve_factored(l, b):
    """Solve (L L^T) x = b given the factor from spd_factor_solve or spd_factor."""
    if library_route(l.shape[-1], l.dtype):
        return _library_solve_factored(l, b)
    return chol_lane.chol_solve_factored_lane(l.contiguous(), b.contiguous())


def spd_solve(a, b):
    """x = a^-1 b for a batch of SPD matrices."""
    if library_route(a.shape[-1], a.dtype):
        return _library_solve_factored(_library_factor(a), b)
    return chol_lane.chol_solve_lane(a.contiguous(), b.contiguous())


TOL_GAP = 1e-12
TOL_FEAS = 1e-10


def solve_qp_box(P, q, lb, max_iter=60, x_init=None, z_init=None, fused_steps=None):
    """Solve a batch of min 1/2 x'Px + q'x s.t. x >= lb. P must be SPD.

    The problem is Jacobi-equilibrated (x = D x~ with D = diag(P)^-1/2) before
    solving, as in the JAX package: an exact reparameterization that removes
    scaling-induced ill-conditioning (cond(P) ~ 1e7 for the overfit weight
    initialization QP) before the float32 factorizations.

    ``max_iter`` is an int or a per-lane integer tensor (B,). ``x_init`` /
    ``z_init`` (B, n) warm-start the interior point.

    ``fused_steps`` (int): instead of the ``while`` loop, run exactly that many
    Mehrotra steps on every lane, with no convergence test and no host sync
    between steps, in one ``ip_steps_lane`` call (the fused CUDA kernel on a
    GPU); ``iterations`` is then ``fused_steps`` on every lane and the polish
    runs as usual (``hybdrt_tpu/ops/qp.py:356-358``).
    """
    lb = lb.expand_as(q)
    chol_lane.QP_ROUTES["library" if library_route(q.shape[-1], q.dtype) else "lane"] += 1
    d_eq = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=1e-300))
    P_orig, q_orig, lb_orig = P, q, lb
    P = P * d_eq[:, :, None] * d_eq[:, None, :]
    q = q * d_eq
    lb = lb / d_eq
    if x_init is not None:
        x_init = x_init / d_eq
    if z_init is not None:
        z_init = z_init * d_eq

    res = _solve_qp_box_core(P, q, lb, max_iter, x_init=x_init, z_init=z_init,
                             fused_steps=fused_steps)
    x = res.x * d_eq
    z = res.z / d_eq
    s = x - lb_orig
    obj = 0.5 * _dot(x, _mv(P_orig, x)) + _dot(q_orig, x)
    return QPResult(x=x, z=z, s=s, gap=_dot(torch.clamp(s, min=0), z),
                    iterations=res.iterations, primal_objective=obj)


def _solve_qp_box_core(P, q, lb, max_iter, x_init=None, z_init=None, fused_steps=None):
    bsz, n = q.shape
    dtype, device = q.dtype, q.device
    # Precision-aware tolerances: float32 cannot reach 1e-12 relative gap
    eps = torch.finfo(dtype).eps
    tol_gap = max(TOL_GAP, 50 * eps)
    tol_feas = max(TOL_FEAS, 50 * eps)
    P = 0.5 * (P + P.mT)

    if x_init is not None:
        # Warm start: push the supplied point strictly interior
        s0 = torch.clamp(x_init - lb, min=1e-4)
        x0 = lb + s0
        if z_init is not None:
            z0 = torch.clamp(z_init, min=1e-4)
        else:
            z0 = torch.clamp(torch.abs(_mv(P, x0) + q), min=1.0)
    else:
        # Damped unconstrained solution pushed interior
        diag_scale = torch.mean(torch.diagonal(P, dim1=-2, dim2=-1), dim=-1)
        x0 = spd_solve(_add_diag(P, (1e-10 * diag_scale + 1e-12)[:, None]), -q)
        s0 = torch.clamp(x0 - lb, min=1.0)
        x0 = lb + s0
        z0 = torch.clamp(torch.abs(_mv(P, x0) + q), min=1.0)

    q_scale = 1.0 + torch.amax(torch.abs(q), dim=-1)

    def converged(x, s, z):
        r_d = _mv(P, x) + q - z
        gap = _dot(s, z) / n
        obj = 0.5 * _dot(x, _mv(P, x)) + _dot(q, x)
        ok_gap = gap <= tol_gap * (1.0 + torch.abs(obj))
        ok_dual = torch.amax(torch.abs(r_d), dim=-1) <= tol_feas * q_scale
        return ok_gap & ok_dual

    if fused_steps is not None:
        if fused_route(n, dtype) == "fused":
            x, s, z = ip_steps_lane(*(t.contiguous() for t in (P, q, lb, x0, s0, z0)),
                                    fused_steps)
        else:
            chol_lane.QP_ROUTES["fused_plain"] += 1
            x, s, z = ip_lane.ip_steps_lane_plain(P, q, lb, x0, s0, z0, int(fused_steps),
                                                  factor_solve=spd_factor_solve,
                                                  solve_factored=spd_solve_factored)
        it = torch.full((bsz,), int(fused_steps), dtype=torch.int32, device=device)
    else:
        max_iter = torch.as_tensor(max_iter, device=device).expand(bsz)
        x, s, z = x0, s0, z0
        it = torch.zeros(bsz, dtype=torch.int32, device=device)
        done = torch.zeros(bsz, dtype=torch.bool, device=device)
        while True:
            # Per-lane loop condition of the vmapped while_loop; a lane that
            # fails it keeps its carry unchanged (one host sync per step)
            live = (it < max_iter) & ~done
            if not bool(live.any()):
                break
            x_new, s_new, z_new, bad = mehrotra_step(P, q, lb, x, s, z, 1e-300,
                                                     spd_factor_solve, spd_solve_factored)
            # NaN/inf guard: a failed step (non-positive pivot in float32)
            # keeps the previous iterate and stops the lane
            keep = (done | bad)[:, None]
            x_new = torch.where(keep, x, x_new)
            s_new = torch.where(keep, s, s_new)
            z_new = torch.where(keep, z, z_new)
            done_new = done | bad | converged(x_new, s_new, z_new)

            step = live[:, None]
            x = torch.where(step, x_new, x)
            s = torch.where(step, s_new, s)
            z = torch.where(step, z_new, z)
            done = torch.where(live, done_new, done)
            it = it + live.to(torch.int32)

    # Active-set polish: clamp near-active bounds and solve the reduced KKT
    # system exactly (sqrt(diag P)-scaled activity test)
    dsqrt = torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=1e-300))
    active = s * dsqrt < z / dsqrt
    free = ~active
    fm = free.to(dtype)
    H = _add_diag(P * fm[:, :, None] * fm[:, None, :], 1.0 - fm)
    rhs = torch.where(free, -q - _mv(P, torch.where(active, lb, 0.0)), lb)
    x_pol = spd_solve(H, rhs)
    x_pol = torch.where(active, lb, x_pol)
    grad = _mv(P, x_pol) + q
    z_pol = torch.where(active, grad, 0.0)
    # The polished point is kept only where it is primal and dual feasible
    valid = (torch.all(x_pol >= lb - 1e-9 * (1 + torch.abs(lb)), dim=-1)
             & torch.all(z_pol >= -tol_feas * q_scale[:, None], dim=-1))[:, None]
    x = torch.where(valid, x_pol, x)
    z = torch.where(valid, z_pol, z)
    s = x - lb

    obj = 0.5 * _dot(x, _mv(P, x)) + _dot(q, x)
    return QPResult(x=x, z=z, s=s, gap=_dot(s, z), iterations=it, primal_objective=obj)
