"""Gaussian radial basis functions in ln(tau) space, host-side float64.

Counterpart of ``hybdrt_tpu/ops/basis.py`` for the gaussian basis (the tau
basis of the EIS, chrono and hybrid fits, and the DOP's default nu basis)
and the delta basis of the DOP (its function, area and evaluation matrix).
Matrix assembly runs once per frequency grid or chrono protocol, so it stays
in numpy/scipy float64 on the host; only the fit loop runs on the device.
"""
import numpy as np
from scipy.special import erf

SQRT_PI = 1.7724538509055159


def _check_gaussian(basis_type):
    if basis_type != "gaussian":
        raise NotImplementedError(
            f"basis_type={basis_type!r}: the port implements the gaussian "
            f"basis only (ROADMAP Queue 1 item 4)")


def gaussian(y, epsilon):
    return np.exp(-((epsilon * y) ** 2))


def delta(y, epsilon=None):
    return np.where(y == 0, 1.0, 0.0)


def get_basis_func(basis_type):
    if basis_type == "delta":
        return delta
    _check_gaussian(basis_type)
    return gaussian


def get_basis_func_area(basis_type, epsilon, zga_params=None):
    """Total area under phi (hybdrt_tpu/ops/basis.py:189)."""
    if basis_type == "delta":
        return 1.0
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
    elif order == 3:
        def func(x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            return -np.sqrt(np.pi / 2) * epsilon ** 5 \
                * (-15 + 45 * a ** 2 - 15 * a ** 4 + a ** 6) * np.exp(-(a ** 2) / 2)
    else:
        raise ValueError(f"Invalid order {order}; must be in 0..3")
    return func


def integrated_derivative_kernel_indefinite(order):
    """func(x, x_n, x_m, epsilon), the indefinite integral of d^k phi_n d^k
    phi_m up to x, for truncated integration limits, k = 0..2
    (hybdrt_tpu/ops/basis.py:232)."""
    def exps(x, x_n, x_m, epsilon):
        e_full = epsilon ** 2 * (2 * x * (x_m + x_n) - (x_m ** 2 + x_n ** 2 + 2 * x ** 2))
        e_erf = epsilon ** 2 * (0.5 * ((x_m + x_n) ** 2 + 4 * x ** 2)
                                - (x_m ** 2 + x_n ** 2 + 2 * x ** 2))
        return e_full, e_erf

    if order == 0:
        def func(x, x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            b = epsilon * (x_m + x_n - 2 * x)
            return erf(b / np.sqrt(2.0)) * (-np.sqrt(np.pi / 8) / epsilon
                                            * np.exp(-0.5 * a ** 2))
    elif order == 1:
        def func(x, x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            b = epsilon * (x_m + x_n - 2 * x)
            e_full, e_erf = exps(x, x_n, x_m, epsilon)
            out = b * np.exp(e_full)
            out = out + 0.5 * np.sqrt(2 * np.pi) * (a ** 2 - 1) * np.exp(e_erf) \
                * erf(b / np.sqrt(2.0))
            return out * 0.5 * epsilon
    elif order == 2:
        def func(x, x_n, x_m, epsilon):
            a = epsilon * (x_m - x_n)
            b = epsilon * (x_m + x_n - 2 * x)
            e_full, e_erf = exps(x, x_n, x_m, epsilon)
            out = 2 * b * np.exp(e_full) * (3 * a ** 2 - 2 * epsilon ** 2
                                            * ((x - x_m) ** 2 + (x - x_n) ** 2) + 1)
            out = out + np.sqrt(2 * np.pi) * (a ** 4 - 6 * a ** 2 + 3) * np.exp(e_erf) \
                * erf(b / np.sqrt(2.0))
            return out * (-0.25 * epsilon ** 3)
    else:
        raise ValueError(f"Invalid order {order}; must be in 0..2 for indefinite kernels")
    return func


def get_basis_func_derivative(basis_type, order):
    """d^order phi / dy^order of the gaussian, order 0..3
    (hybdrt_tpu/ops/basis.py:110-121)."""
    if order == 0:
        return get_basis_func(basis_type)
    if basis_type == "delta":
        raise ValueError(f"Derivative of order {order} not implemented for basis type "
                         f"{basis_type}")
    _check_gaussian(basis_type)
    if order == 1:
        return lambda y, epsilon: -2 * epsilon ** 2 * y * gaussian(y, epsilon)
    if order == 2:
        return lambda y, epsilon: (-2 * epsilon ** 2 + 4 * epsilon ** 4 * y ** 2) \
            * gaussian(y, epsilon)
    if order == 3:
        return lambda y, epsilon: (12 * epsilon ** 4 * y - 8 * epsilon ** 6 * y ** 3) \
            * gaussian(y, epsilon)
    raise ValueError(f"Derivative of order {order} not implemented for basis type {basis_type}")


def construct_func_eval_matrix(basis_grid, eval_grid=None, basis_type="gaussian",
                               epsilon=1.0, order=0):
    """em @ x = the order-th derivative of the fitted distribution at
    eval_grid (hybdrt_tpu/ops/basis.py:270-279), in numpy float64."""
    func = get_basis_func_derivative(basis_type, order)
    basis_grid = np.asarray(basis_grid, dtype=float)
    eval_grid = basis_grid if eval_grid is None else np.asarray(eval_grid, dtype=float)
    return func(eval_grid[:, None] - basis_grid[None, :], epsilon)


_EVAL_MATRIX_HOST_CACHE = {}
_EVAL_MATRIX_HOST_CACHE_MAX = 64


def func_eval_matrix_host(basis_grid, eval_grid=None, basis_type="gaussian", epsilon=1.0,
                          order=0):
    """:func:`construct_func_eval_matrix`, cached by its grids and settings
    for the host-side getters (``predict_drt``, the map's post-fit
    pipeline), as hybdrt_tpu/ops/basis.py:285-320 caches it. The cache keeps
    the last 64 matrices, read-only."""
    basis_grid = np.asarray(basis_grid, dtype=float)
    eval_grid = basis_grid if eval_grid is None else np.asarray(eval_grid, dtype=float)
    key = (basis_grid.tobytes(), eval_grid.tobytes(), basis_type,
           None if epsilon is None else float(epsilon), int(order))
    em = _EVAL_MATRIX_HOST_CACHE.get(key)
    if em is None:
        em = construct_func_eval_matrix(basis_grid, eval_grid, basis_type, epsilon, order)
        em.flags.writeable = False
        if len(_EVAL_MATRIX_HOST_CACHE) >= _EVAL_MATRIX_HOST_CACHE_MAX:
            # user-supplied eval grids vary per call; bound the cache
            _EVAL_MATRIX_HOST_CACHE.pop(next(iter(_EVAL_MATRIX_HOST_CACHE)))
        _EVAL_MATRIX_HOST_CACHE[key] = em
    return em


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
    basis function to a unit current step, ideal or rising as
    1 - exp(-t / tau_rise) (``expdecay``) (hybdrt_tpu/ops/basis.py:367-398).
    Galvanostatic mode only, as in the JAX package: the potentiostatic
    response is the delta-basis closed form of
    ``mat1d.construct_response_matrix``."""
    if op_mode != "galv":
        raise ValueError("Response integrand only defined for galvanostatic mode; "
                         "potentiostatic response uses the delta-basis closed form")
    f_basis = get_basis_func(basis_type)
    if step_model == "ideal":
        def func(y, tau_m, t_n, epsilon, tau_rise):
            return f_basis(y, epsilon) * (1 - np.exp(-t_n / (tau_m * np.exp(y))))
        return func
    if step_model == "expdecay":
        def func(y, tau_m, t_n, epsilon, tau_rise):
            tau = np.exp(y) * tau_m
            # tau_rise = 0 (an ideal step's table) gives exp(-inf) = 0 and a
            # zero factor, as in the JAX package
            with np.errstate(divide="ignore"):
                return f_basis(y, epsilon) * (1 - np.exp(-t_n / tau)
                                              + (tau_rise / (tau_rise - tau))
                                              * (np.exp(-t_n / tau) - np.exp(-t_n / tau_rise)))
        return func
    raise ValueError(f"Invalid step_model {step_model!r}")
