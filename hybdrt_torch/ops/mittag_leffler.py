"""Mittag-Leffler functions E_{a,b}(-x) and E^g_{a,b}(-x) for x >= 0, in
numpy float64 (counterpart of ``hybdrt_tpu/ops/mittag_leffler.py``).

The Cole-Cole and ZGA bases' step responses are t^a E_{a,a+1}(-t^a) in
t / tau (``mat1d.construct_response_matrix``). Both functions are the JAX
package's series/asymptotic blend, with its crossover, term counts and
masking:

  * power series  E^g_{a,b}(-x) = sum_k (g)_k (-x)^k / (k! Gamma(ak+b))
  * asymptotic    E^g_{a,b}(-x) ~ x^{-g}/Gamma(g) *
                    sum_k Gamma(g+k) (-1)^k x^{-k} / (k! Gamma(b-a(g+k)))

The series is alternating with terms that peak near exp(x^{1/a}); in float64
its cancellation noise is ~1e-16 * exp(x^{1/a}), so the blend switches to
the asymptotic branch at x = CROSS^a (x^{1/a} = 20), where the noise is
still ~5e-8 absolute. The asymptotic series diverges; terms beyond
k* ~ x^{1/a}/a - g are masked out (near-optimal truncation). Both are
defined for 0 < a <= 1.
"""
import numpy as np
from scipy.special import gammaln

_CROSS = 20.0  # blend point in x^{1/a}
_SERIES_TERMS = 120
_ASYM_TERMS = 40


def _rgamma(z):
    """1 / Gamma(z) for any real z (zero at the non-positive integers),
    by reflection below 1/2."""
    z = np.asarray(z, dtype=float)
    pos = z > 0.5
    zp = np.where(pos, z, 1.0 - z)
    g = np.exp(gammaln(zp))
    return np.where(pos, 1.0 / g, np.sin(np.pi * z) * g / np.pi)


def prabhakar_ml_neg(x, a, b, g, series_terms=_SERIES_TERMS, asym_terms=_ASYM_TERMS):
    """The three-parameter (Prabhakar) Mittag-Leffler function
    E^g_{a,b}(-x), elementwise for x >= 0, 0 < a <= 1, g > 0."""
    x = np.asarray(x, dtype=float)
    a = np.asarray(a, dtype=float)
    crossover = _CROSS ** a

    shape = (series_terms,) + (1,) * x.ndim
    k_s = np.arange(series_terms, dtype=float).reshape(shape)
    x_small = np.minimum(x, crossover)  # clamp the unused branch
    logx_small = np.log(np.maximum(x_small, 1e-300))
    # log[(g)_k / k!] = gammaln(g+k) - gammaln(g) - gammaln(k+1)
    log_poch = gammaln(g + k_s) - gammaln(g) - gammaln(k_s + 1.0)
    with np.errstate(over="ignore", invalid="ignore"):
        terms_s = (-1.0) ** k_s * np.exp(k_s * logx_small + log_poch) * _rgamma(a * k_s + b)
    series = np.sum(terms_s, axis=0)

    shape = (asym_terms,) + (1,) * x.ndim
    k_a = np.arange(asym_terms, dtype=float).reshape(shape)
    x_big = np.maximum(x, crossover)
    logx_big = np.log(x_big)
    log_coef = gammaln(g + k_a) - gammaln(g) - gammaln(k_a + 1.0)
    with np.errstate(over="ignore", invalid="ignore"):
        terms_a = (-1.0) ** k_a * np.exp(-(g + k_a) * logx_big + log_coef) \
            * _rgamma(b - a * (g + k_a))
        # divergent series: mask terms past the turning point k* ~ x^{1/a}/a - g
        k_opt = np.exp(logx_big / a) / a - g
    terms_a = np.where(k_a <= k_opt, terms_a, 0.0)
    asym = np.sum(terms_a, axis=0)

    return np.where(x < crossover, series, asym)


def mittag_leffler_neg(x, a, b, series_terms=_SERIES_TERMS, asym_terms=_ASYM_TERMS,
                       crossover=None):
    """The two-parameter Mittag-Leffler function E_{a,b}(-x), elementwise for
    x >= 0: the g = 1 Prabhakar function. ``crossover`` is taken and ignored,
    as in the JAX package: the blend point follows ``a``."""
    return prabhakar_ml_neg(x, a, b, 1.0, series_terms=series_terms, asym_terms=asym_terms)
