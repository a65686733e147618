"""Port parity: the tau bases other than gaussian, their quadrature and
closed-form assembly, and the Mittag-Leffler functions
(hybdrt_torch/ops/basis.py, ops/lookup.py, ops/mat1d.py,
ops/mittag_leffler.py) against hybdrt_tpu's on the CPU, float64.

Every basis type of hybdrt_tpu/utils/validation.py:4-5, the ZGA basis on
the parameters ``get_basis_approx_params`` gives (the JAX package's, so that
both packages evaluate the same expansion; the port's own parameters are
held to the JAX package's separately): each function and derivative of
orders 0-3 on a seeded grid, its area, evaluation matrix, impedance and
response integrand, lookup tables, impedance and response matrices (closed
form, interp and trapz, ideal and ``expdecay`` steps, potentiostatic) and
integrated-derivative matrices, within 1e-12 of each array's max |.|, or the
same exception type and message where the JAX package raises. The
Mittag-Leffler functions, and the Cole-Cole and ZGA step responses built on
them, are held within 1e-7 absolute, the series' stated cancellation noise
near its crossover (hybdrt_tpu/ops/mittag_leffler.py:15-22), or where the
noise is larger within 4 eps sum_k |t_k|, the rounding the alternating sum
of its terms t_k carries (``_ml_noise``; each package rounds each term by
an ulp or two, and near the crossover sum_k |t_k| reaches ~5e9, so the two
part by up to 1.6e-6 at b = 1 and 1.7e-7 at b = a + 1, the responses'), at
a in {0.5, 0.8, 0.95, 1} and x over 1e-6 to 1e6.
"""
import numpy as np
import pytest
import torch

from hybdrt_tpu.ops import basis as jbasis, lookup as jlookup, mat1d as jmat1d
from hybdrt_tpu.ops import mittag_leffler as jml
from hybdrt_tpu.utils.validation import basis_options
from hybdrt_torch.ops import basis as tbasis, lookup as tlookup, mat1d as tmat1d
from hybdrt_torch.ops import mittag_leffler as tml

torch.set_num_threads(1)

RTOL = 1e-12
ML_ATOL = 1e-7
EPS = 4.3
Y = np.random.default_rng(0).uniform(-3, 3, 41)
Y[::8] = 0.0  # the delta and step bases' points
GRID = np.linspace(-16, 2, 19)            # ln tau of a basis
EVAL = np.linspace(-17, 3, 33)
FREQ = np.logspace(5, -1, 21)
TAU = np.logspace(-7, 1, 17)
TIMES = np.concatenate([np.linspace(-5e-3, -5e-4, 4), np.logspace(-5, 0, 15)])
STEP_TIMES, STEP_SIZES = np.array([0.0, 0.3]), np.array([1.0, -0.5])
QUADRATURE = [b for b in basis_options if b not in ("Cole-Cole", "zga", "delta")]
# ZGA parameters from a short approximation of the gaussian (7 Cole-Cole
# functions at a fixed epsilon); the bounded search is held below
ZGA = jbasis.get_basis_approx_params("gaussian", "Cole-Cole", EPS, 0.6, num_bases=7)
ZGA = tuple(np.asarray(p, dtype=float) if np.ndim(p) else float(p) for p in ZGA)


def _ml_noise(x, a, b, g=1.0):
    """4 eps sum_k |t_k| (2 + |e_k| + |gammaln(z_k)|) of the branch each x
    takes (the series below the crossover 20^a, the masked asymptotic
    series above it), at least ML_ATOL: t_k = exp(e_k) / Gamma(z_k) is each
    term, whose exponent and gamma function each package rounds by an ulp
    or two, so the alternating sums part by up to about this. The measured
    gaps stay within a quarter of it (0.53 of the unscaled sum at worst)."""
    from scipy.special import gammaln
    x = np.asarray(x, dtype=float)
    eps = np.finfo(float).eps
    k = np.arange(120.0).reshape((120,) + (1,) * x.ndim)
    log_poch = gammaln(g + k) - gammaln(g) - gammaln(k + 1.0)

    def err(e, z):
        with np.errstate(all="ignore"):
            rg = np.abs(tml._rgamma(z))
            t = np.where(rg > 0, np.exp(e) * rg, 0.0)
            return t * (2 + np.abs(e) + np.where(rg > 0, np.abs(gammaln(z)), 0.0))

    xs = np.maximum(np.minimum(x, 20 ** a), 1e-300)
    series = np.sum(err(k * np.log(xs) + log_poch, a * k + b), axis=0)
    k = k[:40]
    xb = np.maximum(x, 20 ** a)
    terms = err(-(g + k) * np.log(xb) + log_poch[:40], b - a * (g + k))
    asym = np.sum(np.where(k <= np.exp(np.log(xb) / a) / a - g, terms, 0.0), axis=0)
    return np.maximum(ML_ATOL, 4 * eps * np.where(x < 20 ** a, series, asym))


def _response_noise(basis_type, epsilon):
    """The Cole-Cole or ZGA response matrices' bounds (A, A_layered): each
    element's (t / tau)^a times its Mittag-Leffler noise, summed over the ZGA
    terms with their |coefficients| and over the steps with their |sizes|."""
    td = TIMES[None, :] - STEP_TIMES[:, None]
    td = np.where(td > 0, td, 1.0)[:, :, None]
    if basis_type == "Cole-Cole":
        parts = [(1.0, TAU, epsilon)]
    else:
        y_basis, coef, eps_zga = ZGA
        parts = [(abs(c), TAU * np.exp(y), eps_zga) for c, y in zip(coef[1:], y_basis)]
    noise = 0.0
    for c, tau, a in parts:
        ratio = (td / tau[None, None, :]) ** a
        noise = noise + c * ratio * _ml_noise(ratio, a, a + 1)
    layered = np.abs(STEP_SIZES)[:, None, None] * noise
    return np.sum(layered, axis=0), layered


def _zga(basis_type):
    return ZGA if basis_type == "zga" else None


def _outcome(fn):
    """("ok", value) or ("raise", (type, message))."""
    try:
        with np.errstate(all="ignore"):
            return "ok", fn()
    except Exception as e:  # noqa: BLE001: any exception is compared
        return "raise", (type(e), str(e))


def _same(got, want, atol=None):
    kind_t, val_t = got
    kind_j, val_j = want
    assert kind_t == kind_j, (got, want)
    if kind_t == "raise":
        assert val_t == val_j
        return
    val_t, val_j = np.asarray(val_t), np.asarray(val_j)
    assert val_t.shape == val_j.shape
    np.testing.assert_array_equal(np.isnan(val_t), np.isnan(val_j))
    fin = np.isfinite(val_j)
    np.testing.assert_array_equal(np.isfinite(val_t), fin)
    if fin.any():
        tol = RTOL * np.max(np.abs(val_j[fin])) if atol is None \
            else np.broadcast_to(atol, val_j.shape)[fin]
        assert np.all(np.abs(val_t[fin] - val_j[fin]) <= tol), np.max(np.abs(val_t - val_j))


def _both(make_t, make_j, atol=None):
    _same(_outcome(make_t), _outcome(make_j), atol)


def _args(basis_type):
    """The function's arguments: beta-rbf takes (y, mu, epsilon)."""
    return (Y, 0.3, EPS) if basis_type == "beta-rbf" else (Y, EPS)


@pytest.mark.parametrize("basis_type", basis_options)
def test_functions_derivatives_and_areas(basis_type):
    for order in range(4):
        _both(lambda: tbasis.get_basis_func_derivative(basis_type, order, _zga(basis_type))(
                  *_args(basis_type)),
              lambda: jbasis.get_basis_func_derivative(basis_type, order, _zga(basis_type))(
                  *_args(basis_type)))
    _both(lambda: tbasis.get_basis_func_area(basis_type, EPS, _zga(basis_type)),
          lambda: jbasis.get_basis_func_area(basis_type, EPS, _zga(basis_type)))
    _both(lambda: tbasis.get_basis_func_integral(basis_type)(Y, EPS),
          lambda: jbasis.get_basis_func_integral(basis_type)(Y, EPS))


@pytest.mark.parametrize("basis_type", basis_options)
def test_eval_matrices(basis_type):
    for order in range(4):
        args = (GRID, EVAL, basis_type, EPS, order, _zga(basis_type))
        want = _outcome(lambda: jbasis.construct_func_eval_matrix(*args))
        _same(_outcome(lambda: tbasis.construct_func_eval_matrix(*args)), want)
        _same(_outcome(lambda: tbasis.func_eval_matrix_host(*args)), want)


@pytest.mark.parametrize("basis_type", basis_options)
def test_integrands(basis_type):
    zga = _zga(basis_type)
    analytic = basis_type in ("Cole-Cole", "zga", "delta")
    w, t = 2 * np.pi * FREQ[:, None], TAU[None, :]
    for part in ("real", "imag"):
        args = (w, t, EPS) if analytic else (Y[None, None, :], w[..., None], t[..., None], EPS)
        _both(lambda: tbasis.get_impedance_func(part, basis_type, zga)(*args),
              lambda: jbasis.get_impedance_func(part, basis_type, zga)(*args))
    for step_model in ("ideal", "expdecay"):
        if basis_type == "delta":
            args = (TAU[None, :], TIMES[5:, None]) + ((1e-4,) if step_model == "expdecay" else ())
        else:
            args = (Y[None, None, :], TAU[None, :, None], TIMES[5:, None, None], EPS, 1e-4)
        _both(lambda: tbasis.get_response_func(basis_type, "galv", step_model, zga)(*args),
              lambda: jbasis.get_response_func(basis_type, "galv", step_model, zga)(*args))
    _both(lambda: tbasis.get_response_func(basis_type, "pot"),
          lambda: jbasis.get_response_func(basis_type, "pot"))


@pytest.mark.parametrize("basis_type", QUADRATURE)
def test_lookups(basis_type):
    """The impedance and response tables of a quadrature basis; beta-rbf's
    integrand cannot take (y, epsilon) in either package."""
    got = _outcome(lambda: tlookup.generate_impedance_lookup(basis_type, EPS, 200))
    want = _outcome(lambda: jlookup.generate_impedance_lookup(basis_type, EPS, 200))
    assert got[0] == want[0]
    if got[0] == "raise":
        _same(got, want)
    else:
        for part in range(2):
            for k in range(2):
                _same(("ok", got[1][part][k]), ("ok", want[1][part][k]))
    for step_model, tr in (("ideal", None), ("expdecay", 1e-4)):
        _both(lambda: tlookup.generate_response_lookup(basis_type, "galv", step_model, EPS, 200,
                                                       tau_rise=tr)[1],
              lambda: jlookup.generate_response_lookup(basis_type, "galv", step_model, EPS, 200,
                                                       tau_rise=tr)[1])


@pytest.mark.parametrize("method", ["interp", "trapz"])
@pytest.mark.parametrize("basis_type", basis_options)
def test_impedance_matrices(basis_type, method):
    for part in ("real", "imag"):
        kw = dict(basis_type=basis_type, epsilon=EPS, integrate_method=method,
                  integrate_points=200, zga_params=_zga(basis_type))
        _both(lambda: tmat1d.construct_impedance_matrix(FREQ, part, TAU, **kw),
              lambda: jmat1d.construct_impedance_matrix(FREQ, part, TAU, **kw))


@pytest.mark.parametrize("case", ["ideal", "expdecay", "trapz", "pot"])
@pytest.mark.parametrize("basis_type", basis_options)
def test_response_matrices(basis_type, case):
    """A[0] and the layered A of two steps; the Cole-Cole and ZGA responses
    within the Mittag-Leffler tolerance."""
    kw = dict(basis_type=basis_type, epsilon=0.95 if basis_type == "Cole-Cole" else EPS,
              zga_params=_zga(basis_type), integrate_points=200,
              step_model="expdecay" if case == "expdecay" else "ideal",
              tau_rise=np.array([1e-4, 1e-4]) if case == "expdecay" else None,
              integrate_method="trapz" if case == "trapz" else "interp",
              op_mode="pot" if case == "pot" else "galv")
    step_model = kw.pop("step_model")
    noise = (None, None)
    if basis_type in ("Cole-Cole", "zga") and case != "pot":
        noise = _response_noise(basis_type, kw["epsilon"])
    got = _outcome(lambda: tmat1d.construct_response_matrix(TAU, TIMES, step_model,
                                                            STEP_TIMES, STEP_SIZES, **kw))
    want = _outcome(lambda: jmat1d.construct_response_matrix(TAU, TIMES, step_model,
                                                             STEP_TIMES, STEP_SIZES, **kw))
    if got[0] == want[0] == "ok":
        for k in range(2):
            _same(("ok", got[1][k]), ("ok", want[1][k]), noise[k])
    else:
        _same(got, want)


@pytest.mark.parametrize("basis_type", basis_options)
def test_integrated_derivative_matrices(basis_type):
    """The gaussian's closed forms, the delta basis's difference operators
    and every other basis's generic ``em @ em`` (ROADMAP Queue 3 item 25),
    orders 0-3."""
    for order in range(4):
        _both(lambda: tmat1d.construct_integrated_derivative_matrix(
                  GRID, basis_type, order, EPS, _zga(basis_type)),
              lambda: jmat1d.construct_integrated_derivative_matrix(
                  GRID, basis_type, order, EPS, _zga(basis_type)))


@pytest.mark.parametrize("a", [0.5, 0.8, 0.95, 1.0])
def test_mittag_leffler(a):
    x = np.logspace(-6, 6, 241)
    for b in (a + 1, 1.0):
        got, want = tml.mittag_leffler_neg(x, a, b), np.asarray(jml.mittag_leffler_neg(x, a, b))
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - want) <= _ml_noise(x, a, b))
    # away from the crossover, 1e-7 itself
    far = np.abs(np.log(x / 20 ** a)) > 1.5
    assert np.max(np.abs(got - want)[far]) <= ML_ATOL
    for g in (0.7, 1.5):
        got = tml.prabhakar_ml_neg(x, a, a * g + 1, g)
        want = np.asarray(jml.prabhakar_ml_neg(x, a, a * g + 1, g))
        assert np.all(np.abs(got - want) <= _ml_noise(x, a, a * g + 1, g))
    if a == 1.0:
        # E_{1,1}(-x) = exp(-x) where the series is exact
        np.testing.assert_allclose(tml.mittag_leffler_neg(x[:120], 1.0, 1.0), np.exp(-x[:120]),
                                   rtol=1e-10, atol=1e-15)


def test_basis_approximation():
    """The port's ZGA parameters, its own box QP at each epsilon and the
    same bounded search: x_basis equal, epsilon and the coefficients within
    the QPs' tolerance of the JAX package's; the fit's expansion against the
    gaussian it approximates."""
    tb = tbasis.get_basis_approx_params("gaussian", "Cole-Cole", EPS, 0.6, num_bases=7)
    np.testing.assert_array_equal(tb[0], ZGA[0])
    assert tb[2] == ZGA[2]
    np.testing.assert_allclose(tb[1], ZGA[1], rtol=1e-6, atol=1e-8 * np.max(np.abs(ZGA[1])))
    # the search of ``DRT.set_zga_params()`` at the default basis's epsilon
    eps = 10 / np.log(10)
    full_t = tbasis.get_basis_approx_params("gaussian", "Cole-Cole", eps, num_bases=7)
    full_j = jbasis.get_basis_approx_params("gaussian", "Cole-Cole", eps, num_bases=7)
    assert full_t[2] == pytest.approx(full_j[2], rel=1e-6)
    np.testing.assert_allclose(full_t[1], full_j[1], rtol=1e-5,
                               atol=1e-6 * np.max(np.abs(full_j[1])))
    x = np.linspace(-1, 1, 101)
    fit = tbasis.evaluate_basis_fit(tb[1], x, tb[0], "Cole-Cole", tb[2])
    np.testing.assert_allclose(fit, np.asarray(jbasis.evaluate_basis_fit(tb[1], x, tb[0],
                                                                         "Cole-Cole", tb[2])),
                               rtol=RTOL, atol=RTOL)
    with pytest.raises(ValueError, match="only implemented for the gaussian"):
        tbasis.get_basis_approx_params("Cole-Cole", "gaussian", EPS)
    with pytest.raises(ValueError, match="No default epsilon"):
        tbasis.fit_basis_functions(x, x, x[:5], "pwl")
