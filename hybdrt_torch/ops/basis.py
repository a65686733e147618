"""Radial basis functions in ln(tau) space (the DRT) and in nu (the DOP),
host-side float64.

Counterpart of ``hybdrt_tpu/ops/basis.py``: every basis function of the JAX
package (gaussian, Cole-Cole, Zic, pwl, step, delta, beta, beta-rbf, ramp,
bounded_ramp, pwl_transformed and the ZGA sum of Cole-Cole functions), their
derivatives, integrals and areas, the gaussian's integrated-derivative
kernels, the function evaluation matrices, the impedance and step-response
integrands, and the basis-approximation fit that builds the ZGA parameters.
Each is the JAX package's expression in numpy, and each raises its
``ValueError`` where it does. Matrix assembly runs once per frequency grid or
chrono protocol, so it stays in numpy/scipy float64 on the host; only the fit
loop runs on the device.
"""
import numpy as np
from scipy.special import erf

SQRT_PI = 1.7724538509055159


# ------------------------------------------------------------------
# Basis functions phi(y, epsilon); y = ln(tau / tau_m) or (nu - nu_m)
# (hybdrt_tpu/ops/basis.py:22-108)
# ------------------------------------------------------------------
def gaussian(y, epsilon):
    return np.exp(-((epsilon * y) ** 2))


def cole_cole(y, epsilon):
    """The ZARC (Cole-Cole) distribution in ln tau."""
    return (1 / (2 * np.pi)) * np.sin((1 - epsilon) * np.pi) / (
        np.cosh(epsilon * y) - np.cos((1 - epsilon) * np.pi))


def zic(y, epsilon=None):
    return 2 * np.exp(y) / (1 + np.exp(2 * y))


def pwl(y, epsilon):
    half_width = 1 / epsilon
    return np.where(np.abs(y) < half_width, (half_width - np.abs(y)) * epsilon, 0.0)


def step(y, epsilon=None):
    return np.where(y >= 0, 1.0, 0.0)


def delta(y, epsilon=None):
    return np.where(y == 0, 1.0, 0.0)


def beta(y, epsilon=None):
    return np.abs(y) * (1 - np.abs(y))


def beta_rbf(y, mu, epsilon):
    """A gaussian centred at mu under the beta envelope; phi(y, mu, epsilon)."""
    return gaussian(y - mu, epsilon) * beta(y)


def ramp(y, epsilon):
    return np.where(y > 0, y * epsilon, 0.0)


def bounded_ramp(y, epsilon):
    width = 1 / epsilon
    return np.clip(y * epsilon, 0.0, 1.0) * np.where(y > 0, 1.0, 0.0) + 0.0 * width


def pwl_transformed(y, epsilon):
    half_width = 1 / epsilon
    rise = (half_width - np.abs(y)) / half_width
    return np.where(y >= 0, 1.0, np.where(y > -half_width, rise, 0.0))


_BASIS_FUNCS = {
    "gaussian": gaussian,
    "Cole-Cole": cole_cole,
    "Zic": zic,
    "pwl": pwl,
    "step": step,
    "delta": delta,
    "beta": beta,
    "beta-rbf": beta_rbf,
    "ramp": ramp,
    "bounded_ramp": bounded_ramp,
    "pwl_transformed": pwl_transformed,
}


def _zga_sum(func, zga_params):
    """sum_i coef[i + 1] func(y + y_i, eps_zga) over the ZGA parameters
    (y_basis, coef, eps_zga)."""
    y_basis, coef, eps_zga = zga_params

    def phi(y, epsilon):
        y = np.asarray(y)
        terms = np.stack([x_i * func(y + y_i, eps_zga) for x_i, y_i in zip(coef[1:], y_basis)])
        return np.sum(terms, axis=0)
    return phi


def get_basis_func(basis_type, zga_params=None):
    """phi(y, epsilon) of ``basis_type``; the ZGA basis's is the sum of its
    Cole-Cole functions (:78-92)."""
    if basis_type == "zga":
        return _zga_sum(cole_cole, zga_params)
    try:
        return _BASIS_FUNCS[basis_type]
    except KeyError:
        raise ValueError(f"Unknown basis_type {basis_type!r}")


# ------------------------------------------------------------------
# Derivatives, integrals and areas (:110-203)
# ------------------------------------------------------------------
def get_basis_func_derivative(basis_type, order, zga_params=None):
    """d^order phi / dy^order (:110-178): the gaussian's of orders 1-3,
    Cole-Cole's and the ZGA sum's of orders 1-2, beta's and beta-rbf's of
    orders 1-2, and pwl's by central differences of step epsilon / 5;
    ``ValueError`` for any other."""
    if order == 0:
        return get_basis_func(basis_type, zga_params)

    if basis_type == "gaussian":
        if order == 1:
            return lambda y, epsilon: -2 * epsilon ** 2 * y * gaussian(y, epsilon)
        if order == 2:
            return lambda y, epsilon: (-2 * epsilon ** 2 + 4 * epsilon ** 4 * y ** 2) \
                * gaussian(y, epsilon)
        if order == 3:
            return lambda y, epsilon: (12 * epsilon ** 4 * y - 8 * epsilon ** 6 * y ** 3) \
                * gaussian(y, epsilon)
    elif basis_type == "Cole-Cole":
        if order == 1:
            def func(y, epsilon):
                nume = -np.sin((1 - epsilon) * np.pi) * np.sinh(epsilon * y) * epsilon
                deno = 2 * np.pi * (np.cosh(epsilon * y) - np.cos((1 - epsilon) * np.pi)) ** 2
                return nume / deno
            return func
        if order == 2:
            def func(y, epsilon):
                c = np.cos((1 - epsilon) * np.pi)
                nume = epsilon ** 2 * np.sin((1 - epsilon) * np.pi) * (
                    2 * np.sinh(epsilon * y) ** 2 - (np.cosh(epsilon * y) - c) * np.cosh(epsilon * y))
                deno = 2 * np.pi * (np.cosh(epsilon * y) - c) ** 3
                return nume / deno
            return func
    elif basis_type == "zga":
        return _zga_sum(get_basis_func_derivative("Cole-Cole", order), zga_params)
    elif basis_type == "beta":
        if order == 1:
            return lambda y, epsilon=None: np.sign(y) - 2 * y
        if order == 2:
            return lambda y, epsilon=None: -2 * np.ones_like(np.asarray(y, dtype=float))
    elif basis_type == "beta-rbf":
        f = gaussian
        fx = get_basis_func_derivative("gaussian", 1)
        g = beta
        gx = get_basis_func_derivative("beta", 1)
        if order == 1:
            return lambda y, mu, epsilon: (f(y - mu, epsilon) * gx(y)
                                           + fx(y - mu, epsilon) * g(y))
        if order == 2:
            fxx = get_basis_func_derivative("gaussian", 2)
            gxx = get_basis_func_derivative("beta", 2)
            return lambda y, mu, epsilon: (gxx(y) * f(y - mu, epsilon)
                                           + 2 * gx(y) * fx(y - mu, epsilon)
                                           + fxx(y - mu, epsilon) * g(y))
    elif basis_type == "pwl":
        def ddiff(f, y, epsilon):
            dy = epsilon / 5
            return (f(y + dy, epsilon) - f(y - dy, epsilon)) / (2 * dy)

        if order == 1:
            return lambda y, epsilon: ddiff(pwl, y, epsilon)
        if order == 2:
            return lambda y, epsilon: ddiff(lambda yy, ee: ddiff(pwl, yy, ee), y, epsilon)

    raise ValueError(f"Derivative of order {order} not implemented for basis type {basis_type}")


def get_basis_func_integral(basis_type):
    """The indefinite integral of phi (:180-186): the gaussian's and the
    delta's."""
    if basis_type == "gaussian":
        return lambda y, epsilon: (SQRT_PI / (2 * epsilon)) * (1 + erf(epsilon * y))
    if basis_type == "delta":
        return lambda y, epsilon: np.where(y >= 0, 1.0, 0.0)
    raise ValueError(f"Basis func integral not implemented for basis_type {basis_type}")


def get_basis_func_area(basis_type, epsilon, zga_params=None):
    """The total area under phi (:189-199): the polarization resistance of a
    unit coefficient."""
    if basis_type == "gaussian":
        return SQRT_PI / epsilon
    if basis_type in ("Cole-Cole", "delta"):
        return 1.0
    if basis_type == "zga":
        return float(len(zga_params[0]))
    if basis_type == "pwl":
        return 1 / epsilon
    raise ValueError(f"Area undefined for basis_type {basis_type}")


# ------------------------------------------------------------------
# Integrated-derivative penalty kernels (the gaussian's closed forms)
# ------------------------------------------------------------------
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


# ------------------------------------------------------------------
# Function evaluation matrices (:270-327)
# ------------------------------------------------------------------
def construct_func_eval_matrix(basis_grid, eval_grid=None, basis_type="gaussian",
                               epsilon=1.0, order=0, zga_params=None):
    """em @ x = the order-th derivative of the fitted distribution at
    eval_grid (:270-279), in numpy float64."""
    func = get_basis_func_derivative(basis_type, order, zga_params)
    basis_grid = np.asarray(basis_grid, dtype=float)
    eval_grid = basis_grid if eval_grid is None else np.asarray(eval_grid, dtype=float)
    return func(eval_grid[:, None] - basis_grid[None, :], epsilon)


_EVAL_MATRIX_HOST_CACHE = {}
_EVAL_MATRIX_HOST_CACHE_MAX = 64


def zga_key(zga_params):
    """A hashable key of the ZGA parameters (None for None)."""
    if zga_params is None:
        return None
    try:
        return tuple(np.asarray(p, dtype=float).tobytes() for p in zga_params)
    except TypeError:
        return np.asarray(zga_params, dtype=float).tobytes()


def func_eval_matrix_host(basis_grid, eval_grid=None, basis_type="gaussian", epsilon=1.0,
                          order=0, zga_params=None):
    """:func:`construct_func_eval_matrix`, cached by its grids and settings
    for the host-side getters (``predict_drt``, the map's post-fit
    pipeline), as :285-320 caches it. The cache keeps the last 64 matrices,
    read-only."""
    basis_grid = np.asarray(basis_grid, dtype=float)
    eval_grid = basis_grid if eval_grid is None else np.asarray(eval_grid, dtype=float)
    key = (basis_grid.tobytes(), eval_grid.tobytes(), basis_type,
           None if epsilon is None else float(epsilon), int(order), zga_key(zga_params))
    em = _EVAL_MATRIX_HOST_CACHE.get(key)
    if em is None:
        em = np.asarray(construct_func_eval_matrix(basis_grid, eval_grid, basis_type, epsilon,
                                                   order, zga_params), dtype=float)
        em.flags.writeable = False
        if len(_EVAL_MATRIX_HOST_CACHE) >= _EVAL_MATRIX_HOST_CACHE_MAX:
            # user-supplied eval grids vary per call; bound the cache
            _EVAL_MATRIX_HOST_CACHE.pop(next(iter(_EVAL_MATRIX_HOST_CACHE)))
        _EVAL_MATRIX_HOST_CACHE[key] = em
    return em


# ------------------------------------------------------------------
# Impedance and time-response integrands (:329-405)
# ------------------------------------------------------------------
def get_impedance_func(part, basis_type="gaussian", zga_params=None):
    """The impedance matrix's element (:329-365): for the analytic bases
    (Cole-Cole, delta, zga) the closed form func(w_n, t_m, epsilon); for the
    quadrature bases the integrand func(y, w_n, t_m, epsilon), y =
    ln(tau / tau_m)."""
    if basis_type == "Cole-Cole":
        if part == "real":
            return lambda w_n, t_m, epsilon: np.real(1 / (1 + (1j * w_n * t_m) ** epsilon))
        return lambda w_n, t_m, epsilon: np.imag(1 / (1 + (1j * w_n * t_m) ** epsilon))
    if basis_type == "delta":
        if part == "real":
            return lambda w_n, t_m, epsilon: 1 / (1 + (w_n * t_m) ** 2)
        return lambda w_n, t_m, epsilon: -w_n * t_m / (1 + (w_n * t_m) ** 2)
    if basis_type == "zga":
        y_basis, coef, eps_zga = zga_params
        f_zarc = get_impedance_func(part, "Cole-Cole")

        def func(w_n, t_m, epsilon):
            terms = np.stack([x_i * f_zarc(w_n, t_m * np.exp(y_i), eps_zga)
                              for x_i, y_i in zip(coef[1:], y_basis)])
            return np.sum(terms, axis=0)
        return func

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


def get_response_func(basis_type, op_mode="galv", step_model="ideal", zga_params=None):
    """The chrono step-response matrix's element (:367-405): the delta
    basis's closed form func(tau_m, t_n) (ideal steps) or func(tau_m, t_n,
    tau_rise) (``expdecay``), else the quadrature integrand func(y, tau_m,
    t_n, epsilon, tau_rise), y = ln(tau / tau_m), of a unit current step,
    ideal or rising as 1 - exp(-t / tau_rise). Galvanostatic mode only, as in
    the JAX package: the potentiostatic response is the delta-basis closed
    form of ``mat1d.construct_response_matrix``."""
    if op_mode != "galv":
        raise ValueError("Response integrand only defined for galvanostatic mode; "
                         "potentiostatic response uses the delta-basis closed form")
    f_basis = get_basis_func(basis_type, zga_params)
    if step_model == "ideal":
        if basis_type == "delta":
            return lambda tau_m, t_n: 1 - np.exp(-t_n / tau_m)

        def func(y, tau_m, t_n, epsilon, tau_rise):
            return f_basis(y, epsilon) * (1 - np.exp(-t_n / (tau_m * np.exp(y))))
        return func
    if step_model == "expdecay":
        if basis_type == "delta":
            def func(tau_m, t_n, tau_rise):
                return (1 - np.exp(-t_n / tau_m)
                        + (tau_rise / (tau_rise - tau_m))
                        * (np.exp(-t_n / tau_m) - np.exp(-t_n / tau_rise)))
            return func

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


# ------------------------------------------------------------------
# Basis-approximation fitting (:410-509): one basis function as a finite
# sum of another family's, which builds the ZGA basis (the gaussian RBF
# approximated by Cole-Cole functions, whose impedance and response are
# closed forms)
# ------------------------------------------------------------------
def _basis_design_matrix(x, basis_x, basis_type, epsilon, fit_intercept):
    """A[n, k] = phi(x_n - basis_x_k, eps_k), after a leading column of ones
    with ``fit_intercept`` (:416-429)."""
    x = np.atleast_1d(np.asarray(x, dtype=float))
    basis_x = np.asarray(basis_x, dtype=float)
    eps = np.broadcast_to(np.asarray(epsilon, dtype=x.dtype), basis_x.shape)
    cols = get_basis_func(basis_type)(x[:, None] - basis_x[None, :], eps[None, :])
    if fit_intercept:
        cols = np.concatenate([np.ones((cols.shape[0], 1)), cols], axis=1)
    return cols


def fit_basis_functions(x, f, basis_x, basis_type, epsilon=None, l1_lambda=0.0,
                        l2_lambda=0.0, nonneg=False, fit_intercept=True):
    """Coefficients c with sum_k c_k phi(x - basis_x_k, eps_k) ~= f(x)
    (:432-462): a bounded least-squares problem solved by this package's box
    QP (``ops/qp.py::solve_qp_box``, one lane, float64 on the CPU), the
    coefficients bounded below by 0 (``nonneg``) or -10. Returns coef with a
    leading intercept entry (0 without ``fit_intercept``)."""
    import torch
    from . import qp
    if epsilon is None:
        if basis_type == "gaussian":
            epsilon = 1.0 / float(np.mean(np.diff(np.asarray(basis_x, float))))
        elif basis_type == "Cole-Cole":
            epsilon = 0.96
        else:
            raise ValueError(f"No default epsilon for basis_type {basis_type!r}")
    a = _basis_design_matrix(x, basis_x, basis_type, epsilon, fit_intercept)
    f = np.atleast_1d(np.asarray(f, dtype=float))
    n = a.shape[1]
    p = a.T @ a + l2_lambda * np.eye(n)
    qv = -(f @ a) + l1_lambda * np.ones(n)
    lb = np.full(n, 0.0 if nonneg else -10.0)
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)[None]
    coef = qp.solve_qp_box(t(p), t(qv), t(lb)).x[0].numpy()
    if not fit_intercept:
        coef = np.concatenate(([0.0], coef))
    return coef


def evaluate_basis_fit(coef, eval_x, basis_x, basis_type, epsilon):
    """A ``fit_basis_functions`` expansion at eval_x (:465-471); coef[0]
    is the intercept."""
    a = _basis_design_matrix(eval_x, basis_x, basis_type, epsilon, fit_intercept=True)
    return a @ np.asarray(coef, dtype=float)


def get_basis_approx_params(exact_basis_type, approx_basis_type, exact_func_epsilon,
                            approx_func_epsilon=None, num_bases=21, basis_extent=2,
                            curvature_penalty=None, nonneg=False):
    """``num_bases`` functions of ``approx_basis_type`` that approximate the
    gaussian (:474-509): (x_basis, coef, epsilon), the ZGA parameters. Without
    ``approx_func_epsilon`` their shared epsilon minimizes ||f_hat -
    f_exact||^2 plus a curvature penalty on the expansion, by scipy's bounded
    scalar minimization over [1e-3, 1]."""
    if exact_basis_type != "gaussian":
        raise ValueError("Basis approximation only implemented for the "
                         "gaussian RBF")
    x_basis = np.linspace(-basis_extent / exact_func_epsilon,
                          basis_extent / exact_func_epsilon, num_bases)
    x_eval = np.linspace(-10 / exact_func_epsilon, 10 / exact_func_epsilon, 2000)
    f_exact = get_basis_func(exact_basis_type)(x_eval, exact_func_epsilon)
    if curvature_penalty is None:
        curvature_penalty = 1e-2 / exact_func_epsilon ** 2

    def fit(eps):
        return fit_basis_functions(x_eval, f_exact, x_basis, approx_basis_type, eps,
                                   nonneg=nonneg, fit_intercept=False)

    if approx_func_epsilon is not None:
        return x_basis, fit(approx_func_epsilon), approx_func_epsilon

    def objective(eps):
        coef = fit(eps)
        f_hat = evaluate_basis_fit(coef, x_eval, x_basis, approx_basis_type, eps)
        p2 = construct_func_eval_matrix(x_basis, x_basis, approx_basis_type, eps, order=2)
        curv = curvature_penalty * (p2 @ coef[1:])
        return float(np.sum((f_hat - f_exact) ** 2) + np.sum(curv ** 2))

    from scipy.optimize import minimize_scalar
    result = minimize_scalar(objective, bounds=(1e-3, 1.0), method="bounded",
                             options={"xatol": 1e-4})
    eps_opt = float(result.x)
    return x_basis, fit(eps_opt), eps_opt
