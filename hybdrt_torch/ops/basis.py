"""Gaussian radial basis functions in ln(tau) space, host-side float64.

Counterpart of ``hybdrt_tpu/ops/basis.py`` for the gaussian basis only (the
basis of the EIS, chrono and hybrid fits). Matrix assembly runs once per
frequency grid or chrono protocol, so it stays in numpy/scipy float64 on the
host; only the fit loop runs on the device.
"""
import numpy as np

SQRT_PI = 1.7724538509055159


def _check_gaussian(basis_type):
    if basis_type != "gaussian":
        raise NotImplementedError(
            f"basis_type={basis_type!r}: the port implements the gaussian "
            f"basis only (ROADMAP Queue 1 item 4)")


def gaussian(y, epsilon):
    return np.exp(-((epsilon * y) ** 2))


def get_basis_func(basis_type):
    _check_gaussian(basis_type)
    return gaussian


def get_basis_func_area(basis_type, epsilon, zga_params=None):
    """Total area under phi (hybdrt_tpu/ops/basis.py:189)."""
    _check_gaussian(basis_type)
    return SQRT_PI / epsilon


def integrated_derivative_kernel(order):
    """func(x_n, x_m, epsilon) = int d^k phi_n d^k phi_m d(ln tau), k = 0..2
    (hybdrt_tpu/ops/basis.py:205)."""
    if order == 0:
        def func(x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            return np.sqrt(np.pi / 2) / epsilon * np.exp(-(a ** 2) / 2)
    elif order == 1:
        def func(x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            return -np.sqrt(np.pi / 2) * epsilon * (-1 + a ** 2) * np.exp(-(a ** 2) / 2)
    elif order == 2:
        def func(x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            return np.sqrt(np.pi / 2) * epsilon ** 3 * (3 - 6 * a ** 2 + a ** 4) \
                * np.exp(-(a ** 2) / 2)
    else:
        raise NotImplementedError(f"order={order}: the port implements orders 0..2")
    return func


def construct_func_eval_matrix(basis_grid, eval_grid=None, basis_type="gaussian",
                               epsilon=1.0, order=0):
    """em @ x = the fitted distribution at eval_grid (order 0 only)."""
    if order != 0:
        raise NotImplementedError("the port implements the order-0 eval matrix only")
    phi = get_basis_func(basis_type)
    basis_grid = np.asarray(basis_grid, dtype=float)
    eval_grid = basis_grid if eval_grid is None else np.asarray(eval_grid, dtype=float)
    return phi(eval_grid[:, None] - basis_grid[None, :], epsilon)


def get_impedance_func(part, basis_type="gaussian"):
    """Quadrature integrand func(y, w_n, t_m, epsilon) of the impedance matrix,
    y = ln(tau / tau_m) (hybdrt_tpu/ops/basis.py:329)."""
    basis_func = get_basis_func(basis_type)
    if part == "real":
        def func(y, w_n, t_m, epsilon):
            return basis_func(y, epsilon) / (1 + np.exp(2 * (y + np.log(w_n * t_m))))
    elif part == "imag":
        def func(y, w_n, t_m, epsilon):
            return -basis_func(y, epsilon) * np.exp(y) * w_n * t_m \
                / (1 + np.exp(2 * (y + np.log(w_n * t_m))))
    else:
        raise ValueError(f"Invalid part {part!r}; options: real, imag")
    return func


def get_response_func(basis_type, op_mode="galv", step_model="ideal"):
    """Quadrature integrand func(y, tau_m, t_n, epsilon, tau_rise) of the
    chrono step-response matrix, y = ln(tau / tau_m): the response of one
    basis function to a unit ideal current step (hybdrt_tpu/ops/basis.py:367;
    galvanostatic mode and ideal steps only, ROADMAP Queue 1 item 11)."""
    if op_mode != "galv":
        raise NotImplementedError(f"op_mode={op_mode!r}: potentiostatic chrono data are not "
                                  f"ported yet (ROADMAP Queue 1 item 11)")
    if step_model != "ideal":
        raise NotImplementedError(f"step_model={step_model!r}: non-ideal steps are not "
                                  f"ported yet (ROADMAP Queue 1 item 11)")
    f_basis = get_basis_func(basis_type)

    def func(y, tau_m, t_n, epsilon, tau_rise):
        return f_basis(y, epsilon) * (1 - np.exp(-t_n / (tau_m * np.exp(y))))
    return func
