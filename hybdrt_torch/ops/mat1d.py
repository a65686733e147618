"""1-D matrix assembly for EIS, chrono and hybrid fits (counterpart of
``hybdrt_tpu/ops/mat1d.py``).

Host-side float64 numpy: the matrices are built once per frequency grid or
chrono protocol and uploaded to the device by the fitter. ``invert_psd``
(the posterior covariances' inverse) runs in torch on the tensor's device.
Every basis of ``ops/basis.py`` is taken as the JAX package takes it: the
Cole-Cole, delta and ZGA bases by their closed forms (the Cole-Cole and ZGA
step responses through ``ops/mittag_leffler.py``), the others by quadrature
over y = ln(tau / tau_m), from the lookup tables of ``ops/lookup.py``
(``integrate_method="interp"``) or by the trapezoid rule at every element
(``"trapz"``). Chrono data take ideal and ``expdecay`` steps, and the
potentiostatic response is the delta-basis closed form of any basis. The
penalty matrices are the gaussian's closed forms (also over truncated
integration limits), the delta basis's difference operators, and for the
other bases the JAX package's squared evaluation matrix (``em @ em``, not
``em.T @ em``; ROADMAP Queue 3 item 25). The capacitance has its impedance
and (ideal-step) response vectors.
"""
import numpy as np
import torch

from .. import preprocessing as pp
from ..utils.chrono import get_time_transforms

from . import basis as basis_mod
from . import lookup as lookup_mod
from . import mittag_leffler as ml

_trapezoid = lookup_mod._trapezoid


def construct_impedance_matrix(frequencies, part, tau, basis_type="gaussian", epsilon=1.0,
                               integrate_method="interp", integrate_points=1000,
                               zga_params=None, interpolate_grids=None):
    """Matrix mapping DRT coefficients to Re or Im impedance at ``frequencies``
    (hybdrt_tpu/ops/mat1d.py:28-57): the closed form of the Cole-Cole, ZGA
    and delta bases; for the others the lookup table interpolated at
    log(w tau) (``np.interp`` clamps at the table ends as ``jnp.interp``
    does), or the trapezoid rule over ``integrate_points`` points of y in
    [-20, 20]."""
    omega = np.asarray(frequencies, dtype=float) * 2 * np.pi
    tau = np.asarray(tau, dtype=float)
    if basis_type in ("Cole-Cole", "zga", "delta"):
        func = basis_mod.get_impedance_func(part, basis_type, zga_params)
        return func(omega[:, None], tau[None, :], epsilon)
    if integrate_method == "interp":
        if interpolate_grids is None:
            re_lu, im_lu = lookup_mod.generate_impedance_lookup(basis_type, float(epsilon))
            interpolate_grids = re_lu if part == "real" else im_lu
        log_wt_grid, z_grid = interpolate_grids
        return np.interp(np.log(omega[:, None] * tau[None, :]), log_wt_grid, z_grid)
    if integrate_method == "trapz":
        y = np.linspace(-lookup_mod.Y_LIMIT, lookup_mod.Y_LIMIT, integrate_points)
        func = basis_mod.get_impedance_func(part, basis_type, zga_params)
        # the integrand over (N_f, N_tau, quad)
        vals = func(y[None, None, :], omega[:, None, None], tau[None, :, None], epsilon)
        return _trapezoid(vals, x=y, axis=-1)
    raise ValueError(f"Invalid integrate_method {integrate_method!r}; options: interp, trapz")


def construct_response_matrix(basis_tau, times, step_model, step_times, step_sizes,
                              basis_type="gaussian", epsilon=0.975, tau_rise=None,
                              op_mode="galv", integrate_method="interp", integrate_points=1000,
                              zga_params=None, interpolate_grids=None):
    """(A, A_layered): A @ x is the modelled response to the input steps,
    and A_layered (n_steps, n_times, n_tau) each step's part of it
    (hybdrt_tpu/ops/mat1d.py:65-144): the potentiostatic closed form of any
    basis; the delta basis's closed form; the Cole-Cole and ZGA bases'
    (t / tau)^a E_{a,a+1}(-(t / tau)^a), each ZGA term at its own tau; and
    the quadrature bases' table (without ``interpolate_grids``, the one of
    this step model and of the first step's ``tau_rise``) or trapezoid rule.
    """
    basis_tau = np.asarray(basis_tau, dtype=float)
    times = np.asarray(times, dtype=float)
    step_times = np.asarray(step_times, dtype=float)
    step_sizes = np.asarray(step_sizes, dtype=float)
    tau_rise = np.zeros(step_times.shape) if tau_rise is None \
        else np.asarray(tau_rise, dtype=float)
    # (n_steps, n_times): the time since each step
    td = times[None, :] - step_times[:, None]
    active = td > 0

    def layered(vals):
        a_layered = np.where(active[:, :, None], vals, 0.0) * step_sizes[:, None, None]
        return np.sum(a_layered, axis=0), a_layered

    if op_mode == "pot":
        # The delta basis's closed form (:88-93)
        with np.errstate(over="ignore", invalid="ignore"):
            expo = np.exp(-td[:, :, None] / basis_tau[None, None, :])
        a_layered = np.where((times[None, :, None] - step_times[:, None, None]) >= 0,
                             expo, 0.0) * step_sizes[:, None, None]
        a_layered = np.nan_to_num(a_layered, nan=0.0)
        return np.sum(a_layered, axis=0), a_layered

    if basis_type == "delta":
        func = basis_mod.get_response_func("delta", op_mode, step_model)
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            if step_model == "ideal":
                vals = func(basis_tau[None, None, :], td[:, :, None])
            else:
                vals = func(basis_tau[None, None, :], td[:, :, None], tau_rise[:, None, None])
        return layered(vals)

    if basis_type in ("Cole-Cole", "zga"):
        td_safe = np.where(active[:, :, None], td[:, :, None], 1.0)

        def zarc_response(tau, eps):
            with np.errstate(over="ignore", invalid="ignore"):
                ratio = (td_safe / tau[None, None, :]) ** eps
                return ratio * ml.mittag_leffler_neg(ratio, eps, eps + 1)

        if basis_type == "Cole-Cole":
            vals = zarc_response(basis_tau, epsilon)
        else:
            eps_zga = zga_params[2]
            y_basis, coef = zga_params[:2]
            vals = sum(x_i * zarc_response(basis_tau * np.exp(y_i), eps_zga)
                       for x_i, y_i in zip(coef[1:], y_basis))
        return layered(vals)

    # The quadrature bases (gaussian etc.)
    td_safe = np.where(active, td, 1.0)
    if integrate_method == "interp":
        if interpolate_grids is None:
            tr = None if step_model == "ideal" else float(tau_rise[0])
            interpolate_grids = lookup_mod.generate_response_lookup(
                basis_type, op_mode, step_model, float(epsilon), tau_rise=tr)
        log_td_grid, response_grid = interpolate_grids
        log_ratio = np.log(td_safe[:, :, None] / basis_tau[None, None, :])
        vals = np.interp(log_ratio, log_td_grid, response_grid)
    elif integrate_method == "trapz":
        y = np.linspace(-lookup_mod.Y_LIMIT, lookup_mod.Y_LIMIT, integrate_points)
        func = basis_mod.get_response_func(basis_type, op_mode, step_model, zga_params)
        # (steps, times, taus, quad)
        vals = func(y[None, None, None, :], basis_tau[None, None, :, None],
                    td_safe[:, :, None, None], epsilon, tau_rise[:, None, None, None])
        vals = _trapezoid(vals, x=y, axis=-1)
    else:
        raise ValueError(f"Invalid integrate_method {integrate_method!r}")
    return layered(vals)


def construct_integrated_derivative_matrix(basis_grid, basis_type="gaussian", order=1,
                                           epsilon=1.0, zga_params=None, integration_limits=None):
    """M with x^T M x = int (d^k gamma / d ln tau^k)^2 d ln tau
    (hybdrt_tpu/ops/mat1d.py:153-211): the gaussian closed form, over
    ``integration_limits`` (a, b) where given, ``order`` one order or a
    list of three weights of orders 0..2; the delta basis's difference
    operators; for any other basis the JAX package's generic form, the
    evaluation matrix of that order times itself (``em @ em``) times the
    grid's mean spacing, which is not positive semi-definite (ROADMAP
    Queue 3 item 25)."""
    basis_grid = np.asarray(basis_grid, dtype=float)
    n = basis_grid.shape[0]
    xx_i, xx_j = basis_grid[None, :], basis_grid[:, None]
    if integration_limits is not None:
        func = basis_mod.integrated_derivative_kernel_indefinite(order)
        a, b = integration_limits
        return func(b, xx_i, xx_j, epsilon) - func(a, xx_i, xx_j, epsilon)
    if basis_type == "gaussian":
        if isinstance(order, (list, tuple)):
            return sum(w * basis_mod.integrated_derivative_kernel(k)(xx_i, xx_j, epsilon)
                       for k, w in enumerate(order))
        return basis_mod.integrated_derivative_kernel(order)(xx_i, xx_j, epsilon)
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
    em = basis_mod.construct_func_eval_matrix(basis_grid, None, basis_type, epsilon, order,
                                              zga_params)
    return (em @ em) * np.mean(np.abs(np.diff(basis_grid)))


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
