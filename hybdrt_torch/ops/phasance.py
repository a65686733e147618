"""Distribution-of-phasances (DOP) basis matrices, host-side float64 numpy.

Counterpart of ``hybdrt_tpu/ops/phasance.py``. The DOP represents
constant-phase features (inductance, capacitance, Warburg) with impedance
(j omega)^nu over a basis in nu in [-1, 1]; the delta basis's columns are
the unit phasors, and every other nu basis's the gaussian's closed-form erf
integrals, as in the JAX package (``hybdrt_tpu/ops/phasance.py:78-119``
takes the gaussian integral whatever the basis). The matrices are built
once per frequency grid or chrono protocol, so they stay in numpy on the
host, as the rest of the assembly does.
"""
import numpy as np
from scipy.special import erf, gammaln

SQRT_PI = 1.7724538509055159


def _complex_erf(z, n_terms=32):
    """erf of a complex argument by the Abramowitz-Stegun 7.1.29 series
    (``hybdrt_tpu/ops/phasance.py:13``), with the same 32 terms so that both
    packages round alike. Accurate to about 1e-14 for |Im z| up to about 3,
    which covers the DOP integral's arguments."""
    z = np.asarray(z, dtype=complex)
    x = z.real
    y = z.imag
    two_xy = 2 * x * y
    x_safe = np.where(x == 0, 1.0, x)
    term1 = np.where(
        x == 0,
        1j * y / np.pi,
        np.exp(-x ** 2) / (2 * np.pi * x_safe) * ((1 - np.cos(two_xy)) + 1j * np.sin(two_xy)),
    )
    k = np.arange(1, n_terms + 1, dtype=float).reshape((n_terms,) + (1,) * x.ndim)
    fk = 2 * x - 2 * x * np.cosh(k * y) * np.cos(two_xy) + k * np.sinh(k * y) * np.sin(two_xy)
    gk = 2 * x * np.cosh(k * y) * np.sin(two_xy) + k * np.sinh(k * y) * np.cos(two_xy)
    series = np.sum(np.exp(-k ** 2 / 4) / (k ** 2 + 4 * x ** 2) * (fk + 1j * gk), axis=0)
    term2 = (2 / np.pi) * np.exp(-x ** 2) * series
    return erf(x) + term1 + term2


def unit_phasor_impedance(omega, nu):
    return (1j * omega) ** nu


def unit_phasor_voltage(t, nu):
    """t^-nu / Gamma(1 - nu); 0 at nu = 1, where gammaln(0) is inf."""
    return t ** (-nu) * np.exp(-gammaln(1 - nu))


def get_nu_limits(nu_m):
    a = np.minimum(0, np.sign(nu_m))
    b = np.maximum(0, np.sign(nu_m))
    return a, b


def _phasor_z_integral(nu, omega, nu_m, epsilon):
    """Indefinite integral of gaussian(nu - nu_m) (j w)^nu d nu (:51)."""
    log_jw = np.log(1j * omega)
    out = 0.5 * SQRT_PI * unit_phasor_impedance(omega, nu_m) / epsilon
    out = out * (1j * omega) ** (log_jw / (4 * epsilon ** 2))
    out = out * _complex_erf(epsilon * (nu - nu_m) - log_jw / (2 * epsilon))
    return out


def _phasor_v_integral(nu, t, nu_m, epsilon):
    """Indefinite integral of gaussian(nu - nu_m) t^-nu / Gamma(1 - nu) d nu,
    Gamma taken at the center nu_m (:61)."""
    log_t = np.log(t)
    out = 0.5 * SQRT_PI * unit_phasor_voltage(t, nu_m) / epsilon
    out = out * t ** (log_t / (4 * epsilon ** 2))
    out = out * erf(epsilon * (nu - nu_m) + log_t / (2 * epsilon))
    return out


def construct_phasor_z_matrix(frequencies, basis_nu, nu_basis_type="gaussian", nu_epsilon=None):
    """Complex (F, n_nu) matrix whose columns are the phasor basis functions'
    impedances (:78)."""
    omega = 2 * np.pi * np.asarray(frequencies, dtype=float)
    basis_nu = np.asarray(basis_nu, dtype=float)
    ww = omega[:, None]
    nn = basis_nu[None, :]
    if nu_basis_type == "delta":
        return unit_phasor_impedance(ww, nn)
    a, b = get_nu_limits(nn)
    return _phasor_z_integral(b, ww, nn, nu_epsilon) - _phasor_z_integral(a, ww, nn, nu_epsilon)


def construct_phasor_v_matrix(times, basis_nu, nu_basis_type, nu_epsilon, step_model,
                              step_times, step_sizes, op_mode="galv"):
    """(rm, rm_layered): the phasor elements' response to current steps
    (:92); galvanostatic data and ideal steps only, with the JAX package's
    ``ValueError`` otherwise."""
    if op_mode != "galv":
        raise ValueError("Phasor response is only implemented for galvanostatic mode")
    if step_model != "ideal":
        raise ValueError("Phasor response is only supported for ideal steps")
    times = np.asarray(times, dtype=float)
    step_times = np.atleast_1d(np.asarray(step_times, dtype=float))
    step_sizes = np.atleast_1d(np.asarray(step_sizes, dtype=float))
    basis_nu = np.asarray(basis_nu, dtype=float)

    td = times[None, :] - step_times[:, None]          # (steps, times)
    active = td > 0
    td_safe = np.where(active, td, 1.0)[:, :, None]    # (steps, times, 1)
    nn = basis_nu[None, None, :]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        if nu_basis_type == "delta":
            vals = unit_phasor_voltage(td_safe, nn)
        else:
            a, b = get_nu_limits(nn)
            vals = (_phasor_v_integral(b, td_safe, nn, nu_epsilon)
                    - _phasor_v_integral(a, td_safe, nn, nu_epsilon))
    rm_layered = np.where(active[:, :, None], vals, 0.0) * step_sizes[:, None, None]
    return np.sum(rm_layered, axis=0), rm_layered


def phasor_scale_vector(nu, basis_tau, quantiles=(0.25, 0.75)):
    """Quantile-based column scale of the DOP coefficients (:119): tau_q^nu,
    tau_q the time constant at the lower quantile of the log tau range for
    nu > 0 and at the upper one for nu <= 0."""
    nu = np.asarray(nu, dtype=float)
    lt = np.log(np.asarray(basis_tau, dtype=float))
    lt_min, lt_max = np.min(lt), np.max(lt)
    lt_range = lt_max - lt_min
    tau_q1 = np.exp(lt_min + quantiles[0] * lt_range)
    tau_q3 = np.exp(lt_min + quantiles[1] * lt_range)
    return np.where(nu <= 0, tau_q3 ** nu, tau_q1 ** nu)
