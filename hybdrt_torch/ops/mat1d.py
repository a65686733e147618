"""1-D matrix assembly for EIS, chrono and hybrid fits (counterpart of
``hybdrt_tpu/ops/mat1d.py``).

Host-side float64 numpy: the matrices are built once per frequency grid or
chrono protocol and uploaded to the device by the fitter. Only the gaussian
basis and the ``integrate_method="interp"`` scheme are implemented, and for
chrono data galvanostatic mode with ideal steps (ROADMAP Queue 1 items 4
and 11).
"""
import numpy as np

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
    (hybdrt_tpu/ops/mat1d.py:65, the quadrature bases' interp branch)."""
    basis_mod._check_gaussian(basis_type)
    if integrate_method != "interp":
        raise NotImplementedError(
            f"integrate_method={integrate_method!r}: the port implements 'interp' only")
    basis_tau = np.asarray(basis_tau, dtype=float)
    times = np.asarray(times, dtype=float)
    step_times = np.asarray(step_times, dtype=float)
    step_sizes = np.asarray(step_sizes, dtype=float)
    if interpolate_grids is None:
        interpolate_grids = lookup_mod.generate_response_lookup(basis_type, op_mode,
                                                                step_model, float(epsilon))
    log_td_grid, response_grid = interpolate_grids
    # (n_steps, n_times): the time since each step
    td = times[None, :] - step_times[:, None]
    active = td > 0
    td_safe = np.where(active, td, 1.0)
    log_ratio = np.log(td_safe[:, :, None] / basis_tau[None, None, :])
    vals = np.interp(log_ratio, log_td_grid, response_grid)
    a_layered = np.where(active[:, :, None], vals, 0.0) * step_sizes[:, None, None]
    return np.sum(a_layered, axis=0), a_layered


def construct_integrated_derivative_matrix(basis_grid, basis_type="gaussian", order=1,
                                           epsilon=1.0):
    """M with x^T M x = int (d^k gamma / d ln tau^k)^2 d ln tau, gaussian closed
    form (hybdrt_tpu/ops/mat1d.py:153-181)."""
    basis_mod._check_gaussian(basis_type)
    basis_grid = np.asarray(basis_grid, dtype=float)
    func = basis_mod.integrated_derivative_kernel(order)
    return func(basis_grid[None, :], basis_grid[:, None], epsilon)


def construct_inductance_response_vector(times, step_model, step_times, step_sizes, tau_rise,
                                         op_mode="galv"):
    """The inductance's step response (hybdrt_tpu/ops/mat1d.py:214): zero
    for ideal steps, the only step model ported."""
    if step_model != "ideal":
        raise NotImplementedError(f"step_model={step_model!r}: non-ideal steps are not "
                                  f"ported yet (ROADMAP Queue 1 item 11)")
    return np.zeros(np.shape(times))


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
