"""1-D matrix assembly for EIS, chrono and hybrid fits (counterpart of
``hybdrt_tpu/ops/mat1d.py``).

Host-side float64 numpy: the matrices are built once per frequency grid or
chrono protocol and uploaded to the device by the fitter. ``invert_psd``
(the posterior covariances' inverse) runs in torch on the tensor's device. The fit matrices
take the gaussian basis and the ``integrate_method="interp"`` scheme (other
bases and ``trapz`` are ROADMAP Queue 1 item 4); chrono data take ideal and
``expdecay`` steps, and the potentiostatic response is the delta-basis
closed form, as in the JAX package. The penalty matrices also take the delta
basis and truncated integration limits, and the capacitance has its
impedance and (ideal-step) response vectors.
"""
import numpy as np
import torch

from .. import preprocessing as pp
from ..utils.chrono import get_time_transforms

from . import basis as basis_mod
from . import lookup as lookup_mod


def construct_impedance_matrix(frequencies, part, tau, basis_type="gaussian", epsilon=1.0,
                               integrate_method="interp", interpolate_grids=None):
    """Matrix mapping DRT coefficients to Re or Im impedance at ``frequencies``
    (hybdrt_tpu/ops/mat1d.py:28-51). ``np.interp`` clamps at the table ends as
    ``jnp.interp`` does."""
    basis_mod._check_gaussian(basis_type)
    if integrate_method != "interp":
        raise NotImplementedError(
            f"integrate_method={integrate_method!r}: the port implements 'interp' only")
    omega = np.asarray(frequencies, dtype=float) * 2 * np.pi
    tau = np.asarray(tau, dtype=float)
    log_wt = np.log(omega[:, None] * tau[None, :])
    if interpolate_grids is None:
        re_lu, im_lu = lookup_mod.generate_impedance_lookup(basis_type, float(epsilon))
        interpolate_grids = re_lu if part == "real" else im_lu
    log_wt_grid, z_grid = interpolate_grids
    return np.interp(log_wt, log_wt_grid, z_grid)


def construct_response_matrix(basis_tau, times, step_model, step_times, step_sizes,
                              basis_type="gaussian", epsilon=0.975, tau_rise=None,
                              op_mode="galv", integrate_method="interp", interpolate_grids=None):
    """(A, A_layered): A @ x is the modelled response to the input steps,
    and A_layered (n_steps, n_times, n_tau) each step's part of it
    (hybdrt_tpu/ops/mat1d.py:65: the potentiostatic closed form of any
    basis, :88-93, and the quadrature bases' interp branch). Without
    ``interpolate_grids`` the table is the one of this step model and of
    the first step's ``tau_rise``."""
    basis_tau = np.asarray(basis_tau, dtype=float)
    times = np.asarray(times, dtype=float)
    step_times = np.asarray(step_times, dtype=float)
    step_sizes = np.asarray(step_sizes, dtype=float)
    # (n_steps, n_times): the time since each step
    td = times[None, :] - step_times[:, None]
    active = td > 0
    if op_mode == "pot":
        # The delta basis's closed form (:88-93)
        with np.errstate(over="ignore", invalid="ignore"):
            expo = np.exp(-td[:, :, None] / basis_tau[None, None, :])
        a_layered = np.where((times[None, :, None] - step_times[:, None, None]) >= 0,
                             expo, 0.0) * step_sizes[:, None, None]
        a_layered = np.nan_to_num(a_layered, nan=0.0)
        return np.sum(a_layered, axis=0), a_layered
    basis_mod._check_gaussian(basis_type)
    if integrate_method != "interp":
        raise NotImplementedError(
            f"integrate_method={integrate_method!r}: the port implements 'interp' only")
    if interpolate_grids is None:
        tr = None if step_model == "ideal" else float(np.atleast_1d(
            0.0 if tau_rise is None else tau_rise)[0])
        interpolate_grids = lookup_mod.generate_response_lookup(basis_type, op_mode, step_model,
                                                                float(epsilon), tau_rise=tr)
    log_td_grid, response_grid = interpolate_grids
    td_safe = np.where(active, td, 1.0)
    log_ratio = np.log(td_safe[:, :, None] / basis_tau[None, None, :])
    vals = np.interp(log_ratio, log_td_grid, response_grid)
    a_layered = np.where(active[:, :, None], vals, 0.0) * step_sizes[:, None, None]
    return np.sum(a_layered, axis=0), a_layered


def construct_integrated_derivative_matrix(basis_grid, basis_type="gaussian", order=1,
                                           epsilon=1.0, integration_limits=None):
    """M with x^T M x = int (d^k gamma / d ln tau^k)^2 d ln tau
    (hybdrt_tpu/ops/mat1d.py:153-211): the gaussian closed form, over
    ``integration_limits`` (a, b) where given, ``order`` one order or a
    list of three weights of orders 0..2; the delta basis's difference
    operators. Other bases are ROADMAP Queue 1 item 4."""
    basis_grid = np.asarray(basis_grid, dtype=float)
    n = basis_grid.shape[0]
    xx_i, xx_j = basis_grid[None, :], basis_grid[:, None]
    if integration_limits is not None:
        func = basis_mod.integrated_derivative_kernel_indefinite(order)
        a, b = integration_limits
        return func(b, xx_i, xx_j, epsilon) - func(a, xx_i, xx_j, epsilon)
    if basis_type == "delta":
        if order == 0:
            return np.eye(n)
        if order == 1:
            lm = np.eye(n)
            np.fill_diagonal(lm[1:, :-1], -1)
            lm[0, 0] = 0
            lm[1:, 1:] /= np.diff(basis_grid)[:, None]
            return lm.T @ lm
        if order == 2:
            lm = np.eye(n) * 2
            lm[0, 0] = 1
            lm[-1, -1] = 1
            np.fill_diagonal(lm[1:, :-1], -1)
            np.fill_diagonal(lm[:-1, 1:], -1)
            lm[1:, 1:] /= np.diff(basis_grid)[:, None]
            lm[:-1, :-1] /= np.diff(basis_grid)[:, None]
            return lm.T @ lm
        raise ValueError(f"Invalid order {order} for delta basis")
    basis_mod._check_gaussian(basis_type)
    if isinstance(order, (list, tuple)):
        return sum(w * basis_mod.integrated_derivative_kernel(k)(xx_i, xx_j, epsilon)
                   for k, w in enumerate(order))
    func = basis_mod.integrated_derivative_kernel(order)
    return func(xx_i, xx_j, epsilon)


def construct_inductance_response_vector(times, step_model, step_times, step_sizes, tau_rise,
                                         op_mode="galv"):
    """The inductance's step response (hybdrt_tpu/ops/mat1d.py:214-226):
    zero for ideal steps; for ``expdecay`` steps the derivative of each
    step's rise, step_size / tau_rise exp(-(t - t_step) / tau_rise)."""
    times = np.asarray(times, dtype=float)
    if step_model != "expdecay":
        return np.zeros(times.shape)
    step_times = np.asarray(step_times, dtype=float)
    step_sizes = np.asarray(step_sizes, dtype=float)
    tau_rise = np.asarray(tau_rise, dtype=float)
    td = times[None, :] - step_times[:, None]
    with np.errstate(over="ignore"):
        vals = (step_sizes / tau_rise)[:, None] * np.exp(-td / tau_rise[:, None])
    return np.sum(np.where(td >= 0, vals, 0.0), axis=0)


def construct_ohmic_response_vector(times, step_model, step_times, step_sizes, tau_rise,
                                    input_signal, smooth, op_mode="galv"):
    """The ohmic resistance's response: the idealized input signal with
    ``smooth``, else the input less its mean before the first step (0 when
    no sample precedes it) (hybdrt_tpu/ops/mat1d.py:228)."""
    times = np.asarray(times)
    input_signal = np.asarray(input_signal)
    if smooth:
        input_signal = pp.generate_model_signal(times, np.asarray(step_times),
                                                np.asarray(step_sizes), tau_rise, step_model)
    else:
        prestep = input_signal[times < np.asarray(step_times)[0]]
        offset = np.mean(prestep) if len(prestep) else 0.0
        input_signal = input_signal - offset
    if op_mode != "galv":
        raise ValueError("Ohmic response vector not implemented for potentiostatic mode")
    return np.asarray(input_signal)


def construct_inductance_impedance_vector(frequencies):
    return 1j * 2 * np.pi * np.asarray(frequencies, dtype=float)


def construct_chrono_var_matrix(times, step_times, vmm_epsilon, error_structure=None):
    """T x T residual-averaging matrix: gaussian weights on the piecewise
    log-time axis, zero between samples of different step segments, rows
    normalized (hybdrt_tpu/ops/mat1d.py:271)."""
    times = np.asarray(times)
    n = len(times)
    if error_structure == "uniform":
        vmm = np.ones((n, n))
    elif error_structure is None:
        _, fwd = get_time_transforms(times, step_times)
        vmm = basis_mod.construct_func_eval_matrix(fwd(times), epsilon=vmm_epsilon, order=0)
        seg_id = np.searchsorted(np.asarray(step_times), times, side="right")
        vmm = np.where(seg_id[:, None] == seg_id[None, :], vmm, 0.0)
    else:
        raise ValueError(f"Invalid error_structure {error_structure!r}")
    return vmm / np.sum(vmm, axis=1, keepdims=True)


def construct_eis_var_matrix(frequencies, vmm_epsilon, reim_cor, error_structure=None):
    """2N x 2N residual-averaging matrix over [Re; Im] with re/im correlation
    (hybdrt_tpu/ops/mat1d.py:293)."""
    frequencies = np.asarray(frequencies, dtype=float)
    n = frequencies.shape[0]
    if error_structure == "uniform":
        vmm_main = np.ones((n, n))
    elif error_structure is None:
        vmm_main = basis_mod.construct_func_eval_matrix(np.log(frequencies),
                                                        epsilon=vmm_epsilon, order=0)
    else:
        raise ValueError(f"Invalid error_structure {error_structure!r}")
    top = np.concatenate([vmm_main, vmm_main * reim_cor], axis=1)
    bot = np.concatenate([vmm_main * reim_cor, vmm_main], axis=1)
    vmm = np.concatenate([top, bot], axis=0)
    return vmm / np.sum(vmm, axis=1, keepdims=True)


# ------------------------------------------------------------------
# PSD inversion
# ------------------------------------------------------------------
def invert_psd(a, use_cholesky=True):
    """Inverse of positive semidefinite matrices (hybdrt_tpu/ops/mat1d.py:313-323):
    ``a`` a torch tensor (n, n) or (B, n, n), inverted in its dtype on its
    device. The Cholesky inverse; a matrix whose factor fails (the JAX
    function's NaN factor) gets the general inverse, as every matrix does
    without ``use_cholesky``."""
    if not use_cholesky:
        return torch.linalg.inv_ex(a)[0]
    l, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    inv = torch.cholesky_solve(eye, l)
    bad = (info != 0) | torch.isnan(l).flatten(-2).any(-1)
    if bool(bad.any()):
        inv = torch.where(bad[..., None, None], torch.linalg.inv_ex(a)[0], inv)
    return inv


def construct_capacitance_response_vector(times, step_model, step_times, step_sizes, tau_rise,
                                          op_mode="galv"):
    """The inverse capacitance's step response, sum of step_size (t -
    t_step) after each step (hybdrt_tpu/ops/mat1d.py:248); ideal steps only,
    with the JAX package's ``ValueError`` otherwise."""
    if step_model != "ideal":
        raise ValueError("Capacitance response not implemented for non-ideal steps")
    times = np.asarray(times, dtype=float)
    step_times = np.atleast_1d(np.asarray(step_times, dtype=float))
    step_sizes = np.atleast_1d(np.asarray(step_sizes, dtype=float))
    td = times[None, :] - step_times[:, None]
    return np.sum(np.where(td >= 0, step_sizes[:, None] * td, 0.0), axis=0)


def construct_capacitance_impedance_vector(frequencies):
    """1 / (j omega) (hybdrt_tpu/ops/mat1d.py:264)."""
    return 1 / (1j * 2 * np.pi * np.asarray(frequencies, dtype=float))
