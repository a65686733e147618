"""QPHB solver core, EIS subset (counterpart of ``hybdrt_tpu/solver/qphb.py``).

Batched functions over a leading lane dimension: the coefficient vector x is
(B, N), the local penalty scales s_vectors (B, K, N), the global derivative
strengths rho_vector (B, K) and the data weights (B, M). The problem matrices
(design ``rm`` (M, N), ``vmm`` (M, M), penalties ``m_stack`` (K, N, N)) are
shared by all lanes, or each lane has its own, with the lane dimension first
(``rm`` (B, M, N), ``vmm`` (B, M, M), ``m_stack`` (B, K, N, N)), as the
ragged fitter's padded systems do; a per-lane system also carries
``col_mask`` (B, N), 1 on a lane's real columns and 0 on its padding, and
``var_floor`` (B,) (``hybdrt_tpu/solver/qphb.py:61-107``, ``:226``). The
shared matrices take the code path they always took. Hyperparameters ``hyp``
are a dict of python floats, device tensors and None, as the JAX package's
hypers pytree.

Parameter layout: x = [special params | DRT coefficients], with
cfg.num_special special columns first.
"""
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.qp import solve_qp_box


@dataclass(frozen=True)
class QPHBConfig:
    """Static configuration of the QPHB problem structure (EIS subset: no DOP,
    outlier or nonlinear blocks)."""
    num_special: int
    dop_start: int = 0
    dop_size: int = 0
    k_range: int = 3
    eff_hp: bool = True
    has_outlier: bool = False
    penalty_type: str = "integral"

    @property
    def fit_dop(self):
        return self.dop_size > 0


@dataclass
class QPHBState:
    """Per-lane solver state; every field has the lane dimension first."""
    x: torch.Tensor               # (B, N)
    s_vectors: torch.Tensor       # (B, K, N)
    rho_vector: torch.Tensor      # (B, K)
    dop_rho_vector: torch.Tensor  # (B, K)
    weights: torch.Tensor         # (B, M)
    outlier_t: torch.Tensor       # (B, M)
    xmx_norms: torch.Tensor       # (B, K)
    dop_xmx_norms: torch.Tensor   # (B, K)
    it: torch.Tensor              # (B,) int32
    converged: torch.Tensor       # (B,) bool
    qp_dual: Optional[torch.Tensor] = None  # (B, N) QP warm-start duals

    def map(self, fn, *others):
        """New state with fn applied field-wise (None fields stay None)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = None if v is None else fn(v, *(getattr(o, f.name) for o in others))
        return QPHBState(**out)


def state_from_numpy(state, device=None, dtype=torch.float64):
    """Convert a state with numpy (or array-like) fields, such as a
    ``hybdrt_tpu`` ``QPHBState`` pulled to the host, into the port's state."""
    out = {}
    for f in dataclasses.fields(QPHBState):
        v = getattr(state, f.name, None)
        if v is None:
            out[f.name] = None
            continue
        v = np.asarray(v)
        if f.name == "it":
            out[f.name] = torch.as_tensor(v, dtype=torch.int32, device=device)
        elif f.name == "converged":
            out[f.name] = torch.as_tensor(v, dtype=torch.bool, device=device)
        else:
            out[f.name] = torch.as_tensor(v, dtype=dtype, device=device)
    return QPHBState(**out)


def hypers_to_tensors(hypers, device=None, dtype=torch.float64):
    """hypers dict -> dict of python floats, tensors on ``device`` and None
    (counterpart of ``hybdrt_tpu/models/drt.py::_hypers_to_pytree``)."""
    out = {}
    for k, v in hypers.items():
        if v is None:
            out[k] = None
        elif np.isscalar(v):
            out[k] = float(v)
        else:
            out[k] = torch.as_tensor(np.asarray(v, dtype=float), dtype=dtype, device=device)
    return out


def _mv(m, x):
    """Matrix times per-lane x (B, N) -> (B, M): a shared (M, N) matrix, or
    each lane's own of a (B, M, N) stack."""
    if m.dim() == 2:
        return torch.matmul(x, m.mT)
    return torch.matmul(m, x[..., None])[..., 0]


def _xmx(x, pm):
    """x^T pm x per lane: x (B, n); pm shared (n, n) or per lane (B, n, n)."""
    if pm.dim() == 2:
        return torch.sum(torch.matmul(x, pm) * x, dim=-1)
    return torch.sum(torch.matmul(x[:, None, :], pm)[:, 0, :] * x, dim=-1)


# ------------------------------------------------------------------
# L2 (SMS) matrix assembly (hybdrt_tpu/solver/qphb.py:60)
# ------------------------------------------------------------------
def calculate_qp_l2_matrix(hyp, rho_vector, m_stack, s_vectors, cfg: QPHBConfig,
                           col_mask=None):
    """l2 = sum_k S_k^1/2 M_k S_k^1/2 with the DRT block of M_k scaled by
    l2_lambda_0 * w_k * rho_k. rho_vector (..., K), s_vectors (..., K, N),
    m_stack (K, N, N) or (B, K, N, N) -> (..., N, N).

    col_mask (B, N) decouples a lane's padded columns from the penalty and
    pins them by a unit diagonal: with zero design columns there, the QP's
    solution is exactly 0 on them and the real block is the unpadded
    problem's."""
    if cfg.fit_dop:
        raise NotImplementedError("DOP penalty blocks are not ported yet")
    n = m_stack.shape[-1]
    dw = hyp["derivative_weights"]
    l2l0 = hyp["l2_lambda_0"]
    ns = cfg.num_special
    drt_mask = torch.ones(n, dtype=m_stack.dtype, device=m_stack.device)
    drt_mask[:ns] = 0.0
    special_mask = 1.0 - drt_mask

    l2_mat = None
    for k in range(cfg.k_range):
        d_factor = l2l0 * dw[k] * rho_vector[..., k]
        scale_vec = special_mask + drt_mask * d_factor[..., None]
        if col_mask is not None:
            scale_vec = scale_vec * col_mask
        d_k = torch.sqrt(s_vectors[..., k, :] * scale_vec)
        active = torch.where(dw[k] > 0, 1.0, 0.0)
        term = active * (m_stack[..., k, :, :] * d_k[..., :, None] * d_k[..., None, :])
        l2_mat = term if l2_mat is None else l2_mat + term
    if col_mask is not None:
        l2_mat = l2_mat + torch.diag_embed(1.0 - col_mask)
    return l2_mat


# ------------------------------------------------------------------
# Closed-form hyperparameter updates (hybdrt_tpu/solver/qphb.py:114-156)
# ------------------------------------------------------------------
def solve_s_integral(pm, x, sv, rho_eff, alpha, beta, g_mat, sigma_ds):
    """Gamma-prior mode update of the local penalty scales s. x, sv (B, n);
    pm (n, n) or (B, n, n); g_mat (B, n, n) or None (a zero matrix)."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    gamma = rho_eff * (x[:, :, None] * pm * x[:, None, :])
    if g_mat is not None:
        gamma = gamma + g_mat / (2 * sigma_ds ** 2)
    gamma = gamma + beta * eye
    u = torch.sqrt(sv)
    gu = gamma * u[:, None, :]
    gu = gu * (1.0 - eye)
    gdiag = torch.diagonal(gamma, dim1=-2, dim2=-1)
    b = torch.sum(gu, dim=-1)
    u_hat = (-b + torch.sign(b) * torch.sqrt(b ** 2 + 4 * gdiag * (alpha - 1))) / (2 * gdiag)
    quad = u_hat ** 2
    diag_sol = (alpha - 1) / gdiag
    coupled = torch.amax(torch.abs(gu), dim=(-2, -1)) > 1e-10
    s_hat = torch.where(coupled[:, None], quad, diag_sol)
    return torch.where(torch.isnan(s_hat), 1.0, s_hat)


def solve_rho(pm, x, sv, alpha, beta, xmx_norm):
    """Gamma-prior mode update of the global derivative strength rho."""
    u = x * torch.sqrt(sv)
    xsmsx = _xmx(u, pm)
    return alpha / (xsmsx / xmx_norm + beta)


# ------------------------------------------------------------------
# Weight estimation (hybdrt_tpu/solver/qphb.py:186-280)
# ------------------------------------------------------------------
def solve_init_weight_scale(w_scale_est, alpha, beta):
    if alpha is None:
        return w_scale_est
    b = 0.5 - alpha + 1
    s_hat = (-b + torch.sqrt(b ** 2 + 2 * beta * w_scale_est ** -2)) / (2 * beta)
    return s_hat ** -0.5


def estimate_weights(x, y, vmm, rm, est_weights=None, var_floor=None):
    """Residual-filtered variance estimate -> weights, damped toward
    est_weights (outlier_p=None branch). Returns (weights, outlier_t)."""
    resid = _mv(rm, x) - y
    outlier_t = torch.ones_like(y)
    if var_floor is None:
        var_floor = torch.var(y, dim=-1, correction=0) * 1e-7
    s_hat = _mv(vmm, resid ** 2)
    s_hat = torch.maximum(s_hat, var_floor[:, None])
    w_hat = s_hat ** -0.5
    if est_weights is not None:
        frac_current = w_hat / (w_hat + est_weights)
        w_hat = frac_current * w_hat + (1 - frac_current) * est_weights
    w_hat = torch.clamp(w_hat, min=1e-10)
    return w_hat, outlier_t


def initialize_weights(iw_hyp, m_stack, rho_vector, s_vectors, rv, rm, vmm, lb,
                       cfg: QPHBConfig, col_mask=None, var_floor=None):
    """Overfit-ridge solve -> residual variance -> initial weights (no-outlier
    branch). rho_vector (K,) and s_vectors (K, N) are shared by all lanes;
    rv is (B, M). With per-lane systems, col_mask (B, N) pins the padded
    columns (unit linear cost there, so with lb = 0 the pinned solution is
    strictly complementary) and var_floor (B,) is each lane's unpadded data
    variance times 1e-7. Returns (est_weights, init_weights, x_overfit,
    outlier_t)."""
    if cfg.has_outlier:
        raise NotImplementedError("the outlier model is not ported yet")
    l2_matrix = calculate_qp_l2_matrix(iw_hyp, rho_vector, m_stack, s_vectors, cfg,
                                       col_mask=col_mask)
    l1_0 = iw_hyp["l1_lambda_0"]
    if col_mask is not None:
        l1_0 = l1_0 * col_mask + (1.0 - col_mask)
    p_matrix = rm.mT @ rm + l2_matrix
    q_vector = -_mv(rm.mT, rv) + l1_0
    x_overfit = solve_qp_box(p_matrix.expand(rv.shape[0], -1, -1), q_vector, lb).x
    est_weights, outlier_t = estimate_weights(x_overfit, rv, vmm, rm, var_floor=var_floor)
    init_weights = solve_init_weight_scale(est_weights, iw_hyp.get("iw_alpha"),
                                           iw_hyp.get("iw_beta"))
    return est_weights, init_weights, x_overfit, outlier_t


def estimate_x_rp(hyp, m_stack, rho_vector, s_vectors, rv, rm, lb, cfg: QPHBConfig,
                  l2_lambda_0=1e-4, l1_lambda_0=1e-3):
    """Quick elastic-net solve for the Rp estimate of ``solve_rp``
    (hybdrt_tpu/solver/qphb.py:283): one QP per lane of rv (B, M), with the
    shared rm (M, N), rho_vector (K,) and s_vectors (K, N)."""
    rp_hyp = dict(hyp)
    rp_hyp["l2_lambda_0"] = l2_lambda_0
    l2_matrix = calculate_qp_l2_matrix(rp_hyp, rho_vector, m_stack, s_vectors, cfg)
    p_matrix = rm.mT @ rm + l2_matrix
    q_vector = -_mv(rm.mT, rv) + l1_lambda_0
    return solve_qp_box(p_matrix.expand(rv.shape[0], -1, -1), q_vector, lb).x


# ------------------------------------------------------------------
# Posterior quantities (hybdrt_tpu/solver/qphb.py:299)
# ------------------------------------------------------------------
def calculate_pq(rm, rv, m_stack, hyp, l1_lambda_vector, rho_vector, s_vectors, weights,
                 cfg: QPHBConfig, col_mask=None):
    """The weighted QP of each lane: P = l2 + (W rm)^T (W rm), q = -(W rm)^T
    (W rv) + l1. rv, weights (B, M); rho_vector (B, K); s_vectors (B, K, N);
    rm (M, N) or (B, M, N) -> P (B, N, N), q (B, N). EIS subset: no DOP
    block, so dop_rho is ones."""
    wrm = rm * weights[:, :, None]
    wrv = rv * weights
    l2_matrix = calculate_qp_l2_matrix(hyp, rho_vector, m_stack, s_vectors, cfg,
                                       col_mask=col_mask)
    p_matrix = wrm.mT @ wrm + l2_matrix
    q_vector = -torch.matmul(wrm.mT, wrv[:, :, None])[:, :, 0] + l1_lambda_vector
    return p_matrix, q_vector


# ------------------------------------------------------------------
# Convergence (hybdrt_tpu/solver/qphb.py:394)
# ------------------------------------------------------------------
def is_converged(x_in, x_out, x_atol, x_rtol):
    x_delta = x_out - x_in
    denom = x_in + 1e-15
    rel_ok = torch.amax(torch.abs(x_delta / denom), dim=-1) <= x_rtol
    abs_ok = torch.amax(torch.abs(x_delta), dim=-1) <= x_atol
    return rel_ok | abs_ok


# ------------------------------------------------------------------
# One outer QPHB iteration (hybdrt_tpu/solver/qphb.py:405)
# ------------------------------------------------------------------
def iterate_qphb(state: QPHBState, rv, rm, vmm, m_stack, m1_gmat_source, l1_lambda_vector,
                 lb, est_weights, hyp, cfg: QPHBConfig, x_rtol=1e-2, qp_max_iter=60,
                 qp_max_iter_warm=None, warm_mode="auto", qp_fused_steps=None,
                 col_mask=None, var_floor=None):
    """Weighted QP for x, closed-form s/rho updates on the DRT block, then data
    weight re-estimation. Returns (new_state, qp_result).

    With ``warm_mode="warm"`` and ``qp_fused_steps``, the warm-started QP runs
    exactly that many Mehrotra steps in one fused call
    (``solve_qp_box(fused_steps=...)``).

    col_mask / var_floor are the per-lane systems' (see
    calculate_qp_l2_matrix): the padded columns of x are pinned to exactly 0
    after the QP, and the convergence test's atol averages x over the real
    columns only (``hybdrt_tpu/solver/qphb.py:464-467``, ``:548-551``)."""
    if cfg.fit_dop or cfg.has_outlier:
        raise NotImplementedError("DOP and outlier blocks are not ported yet")
    ns = cfg.num_special
    dw = hyp["derivative_weights"]

    p_matrix, q_vector = calculate_pq(rm, rv, m_stack, hyp, l1_lambda_vector,
                                      state.rho_vector, state.s_vectors, state.weights, cfg,
                                      col_mask=col_mask)
    if warm_mode == "cold" or state.qp_dual is None:
        qp_res = solve_qp_box(p_matrix, q_vector, lb, max_iter=qp_max_iter)
    elif warm_mode == "warm":
        z_ws = torch.clamp(state.qp_dual, min=1e-6)
        if qp_fused_steps is not None:
            qp_res = solve_qp_box(p_matrix, q_vector, lb, x_init=state.x, z_init=z_ws,
                                  fused_steps=int(qp_fused_steps))
        else:
            cap = qp_max_iter if qp_max_iter_warm is None else qp_max_iter_warm
            qp_res = solve_qp_box(p_matrix, q_vector, lb, max_iter=cap, x_init=state.x,
                                  z_init=z_ws)
    elif warm_mode == "auto":
        # Per-lane warm start from the previous iteration's primal/dual point
        warm = (state.it > 0)[:, None]
        x_ws = torch.where(warm, state.x, lb + 1.0)
        z_ws = torch.where(warm, torch.clamp(state.qp_dual, min=1e-6),
                           torch.clamp(torch.abs(q_vector), min=1.0))
        if qp_max_iter_warm is None:
            cap = qp_max_iter
        else:
            cap = torch.where(state.it > 0, qp_max_iter_warm, qp_max_iter)
        qp_res = solve_qp_box(p_matrix, q_vector, lb, max_iter=cap, x_init=x_ws,
                              z_init=z_ws)
    else:
        raise ValueError(f"warm_mode={warm_mode!r}: expected 'auto', 'warm' or 'cold'")
    x = qp_res.x
    if col_mask is not None:
        x = x * col_mask

    # DRT block hyperparameter updates (one pass: max_hp_iter=1 in the JAX
    # package's fit loop)
    x_drt = x[:, ns:]
    new_s = []
    new_rho = []
    for k in range(cfg.k_range):
        pm_drt = m_stack[..., k, ns:, ns:]
        sv_drt = state.s_vectors[:, k, ns:]
        s_k_alpha = hyp["s_alpha"][k]
        s_k_beta = (s_k_alpha - 1) / hyp["s_0"][k]
        rho_k_eff = 1.0 if cfg.eff_hp else state.rho_vector[:, k, None, None]
        if k == 0:
            sx = torch.sign(x_drt) * torch.sqrt(torch.abs(x_drt))
            g_mat_drt = m1_gmat_source[..., ns:, ns:] * sx[:, :, None] * sx[:, None, :]
        else:
            g_mat_drt = None
        sv_out = solve_s_integral(pm_drt, x_drt, sv_drt, rho_k_eff, s_k_alpha, s_k_beta,
                                  g_mat_drt, hyp["sigma_ds"][k])
        sv_out = torch.where(sv_out <= 0, 1e-15, sv_out)

        rho_k_alpha = hyp["rho_alpha"][k]
        rho_k_beta = rho_k_alpha / hyp["rho_0"][k]
        rho_k = solve_rho(pm_drt, x_drt, sv_out, rho_k_alpha, rho_k_beta,
                          state.xmx_norms[:, k])
        # Skip updates for zero-weighted derivative orders
        active = dw[k] > 0
        new_s.append(torch.where(active, sv_out, sv_drt))
        new_rho.append(torch.where(active, rho_k, state.rho_vector[:, k]))
    s_vectors = torch.cat([state.s_vectors[:, :, :ns], torch.stack(new_s, dim=1)], dim=2)
    rho_vector = torch.stack(new_rho, dim=1)

    weights, outlier_t = estimate_weights(x, rv, vmm, rm, est_weights=est_weights,
                                          var_floor=var_floor)
    if col_mask is None:
        x_atol = torch.mean(state.x, dim=-1) * 1e-3
    else:
        x_atol = torch.sum(state.x * col_mask, dim=-1) / torch.sum(col_mask, dim=-1) * 1e-3
    converged = is_converged(state.x, x, x_atol, x_rtol)
    new_state = QPHBState(
        x=x, s_vectors=s_vectors, rho_vector=rho_vector,
        dop_rho_vector=state.dop_rho_vector, weights=weights, outlier_t=outlier_t,
        xmx_norms=state.xmx_norms, dop_xmx_norms=state.dop_xmx_norms,
        it=state.it + 1, converged=converged,
        qp_dual=qp_res.z if state.qp_dual is not None else None)
    return new_state, qp_res
