"""Probability helpers on the host (numpy/scipy).

Copy of the numpy helpers of ``hybdrt_tpu/utils/stats.py``: ``robust_std``
(:59), which the map's QC reaches, and the other numpy and scipy ones
(:10, :66-133). The jnp densities of :14-56 (``pdf_normal`` ...
``pdf_laplace``) are not ported: no ported path uses them.
"""
import numpy as np


def harmonic_mean(x, y):
    return 2 * x * y / (x + y)


def robust_std(x, axis=None):
    """IQR-based robust standard deviation estimate."""
    x = np.asarray(x)
    iqr = np.nanpercentile(x, 75, axis=axis) - np.nanpercentile(x, 25, axis=axis)
    return iqr / 1.349


def bic(llh, num_params, num_data):
    """Bayesian information criterion (reference: utils/stats.py:137)."""
    return num_params * np.log(num_data) - 2 * llh


def bayes_factor(bic_1, bic_2):
    """Approximate Bayes factor of model 2 vs model 1 from BICs."""
    return np.exp((bic_1 - bic_2) / 2)


def pdf_lognormal(x, mu, sigma):
    x = np.asarray(x, dtype=float)
    return np.exp(-0.5 * ((np.log(x) - mu) / sigma) ** 2) \
        / (x * sigma * np.sqrt(2 * np.pi))


def std_normal_quantile(quantiles):
    """Standard-normal values at the given quantiles
    (reference utils/stats.py:108)."""
    from scipy.special import ndtri
    return ndtri(np.asarray(quantiles, dtype=float))


def iqr(x):
    return np.percentile(x, 75) - np.percentile(x, 25)


def norm_bayes_factors(crit_values, criterion="bic"):
    """Bayes factors of each model relative to the best
    (reference utils/stats.py:157)."""
    crit_values = np.asarray(crit_values, dtype=float)
    if criterion == "bic":
        return np.exp(-0.5 * (crit_values - np.min(crit_values)))
    if criterion in ("llh", "lml", "lml-bic"):
        return np.exp(crit_values - np.max(crit_values))
    raise ValueError(f"Invalid criterion {criterion}")


def outer_cdf_chi2(x, scale, k, loc=0.0):
    """P(chi2 more extreme than x) (reference utils/stats.py)."""
    from scipy.stats import chi2
    return 1 - chi2.cdf(x, k, loc=loc, scale=scale)


def pdf_beta(x, a, b):
    """Beta(a, b) density (reference utils/stats.py)."""
    from scipy.special import betaln
    x = np.asarray(x, dtype=float)
    return np.exp((a - 1) * np.log(x) + (b - 1) * np.log1p(-x) - betaln(a, b))


def log_pdf_beta(x, a, b):
    from scipy.special import betaln
    x = np.asarray(x, dtype=float)
    return (a - 1) * np.log(x) + (b - 1) * np.log1p(-x) - betaln(a, b)


def pdf_dirichlet(x, alpha):
    """Dirichlet(alpha) density (reference utils/stats.py)."""
    return np.exp(log_pdf_dirichlet(x, alpha))


def log_pdf_dirichlet(x, alpha):
    from scipy.special import gammaln
    x = np.asarray(x, dtype=float)
    alpha = np.asarray(alpha, dtype=float)
    return (np.sum((alpha - 1) * np.log(x), axis=-1)
            + gammaln(np.sum(alpha)) - np.sum(gammaln(alpha)))
