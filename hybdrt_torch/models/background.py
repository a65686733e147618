"""The chrono voltage baseline and the GP background (counterpart of
``hybdrt_tpu/models/background.py``).

The baseline (``get_baseline_matrix``, :13-25) is a polynomial in time, and
optionally sqrt(t), that enters the QP design matrix as the ``v_baseline``
columns. The flexible background (``GPBackground``, :44-137) is an exact GP
regression of a fit's residual drift with its hyperparameters chosen by a
grid search over the log marginal likelihood; ``get_background_matrix``
(:148-162) is its smoothing operator K* K^-1, which the background modes of
``DRT._qphb_fit_core`` subtract, project out or scale. This is small dense
algebra on the host, numpy and scipy's Cholesky in float64, where the JAX
package ran ``jnp.linalg`` on the host.
"""
import numpy as np
from scipy import linalg as sp_linalg


def get_baseline_matrix(times, deg, normalize=False, sqrt=False):
    """(T, deg + 1 [+ 1]) design matrix of the voltage baseline: columns
    (t - t0)^n, n = 0..deg, and (t - t0)^0.5 with ``sqrt``. With
    ``normalize`` each column is divided by its largest value (1 where that
    is 0) and (matrix, scales) is returned."""
    times = np.asarray(times)
    vb_mat = np.zeros((len(times), deg + 1 + int(sqrt)))
    for n in range(deg + 1):
        vb_mat[:, n] = (times - times[0]) ** n
    if sqrt:
        vb_mat[:, -1] = (times - times[0]) ** 0.5
    if normalize:
        scales = np.max(vb_mat, axis=0)
        scales[scales == 0] = 1.0
        return vb_mat / scales[None, :], scales
    return vb_mat


def _rbf_kernel(x1, x2, length_scale, variance):
    d = (x1[:, None] - x2[None, :]) / length_scale
    return variance * np.exp(-0.5 * d ** 2)


def _periodic_kernel(x1, x2, length_scale, periodicity, variance):
    d = np.abs(x1[:, None] - x2[None, :])
    return variance * np.exp(-2 * (np.sin(np.pi * d / periodicity) / length_scale) ** 2)


def _cholesky(k):
    """The lower Cholesky factor of k, or None where k is not positive
    definite (``jnp.linalg.cholesky`` gives NaN there)."""
    try:
        return sp_linalg.cholesky(k, lower=True)
    except np.linalg.LinAlgError:
        return None


class GPBackground:
    """Exact GP regression with an RBF ("gaussian"), periodic or locally
    periodic ("locper") kernel, its length scale, noise level and
    periodicity chosen from log-spaced grids of ``n_grid`` points by the
    log marginal likelihood of the standardized data (:44-137)."""

    def __init__(self, kernel_type="gaussian", length_scale_bounds=(0.01, 10),
                 periodicity_bounds=(1e-3, 1e3), noise_level_bounds=(0.1, 10), n_grid=8):
        self.kernel_type = kernel_type
        self.length_scale_bounds = length_scale_bounds
        self.periodicity_bounds = periodicity_bounds
        self.noise_level_bounds = noise_level_bounds
        self.n_grid = n_grid
        self.params_ = None
        self.x_train_ = None
        self.alpha_ = None
        self.chol_ = None
        self.y_std_ = 1.0
        self.y_mean_ = 0.0

    def _kernel(self, x1, x2, params):
        if self.kernel_type == "periodic":
            return _periodic_kernel(x1, x2, params["length_scale"], params["periodicity"], 1.0)
        if self.kernel_type == "locper":
            return _rbf_kernel(x1, x2, params["length_scale"] * 10, 1.0) * \
                _periodic_kernel(x1, x2, params["length_scale"], params["periodicity"], 1.0)
        return _rbf_kernel(x1, x2, params["length_scale"], 1.0)

    def _lml(self, x, y, params):
        n = x.shape[0]
        chol = _cholesky(self._kernel(x, x, params) + params["noise"] * np.eye(n))
        if chol is None:
            return np.nan
        alpha = sp_linalg.cho_solve((chol, True), y)
        return -0.5 * y @ alpha - np.sum(np.log(np.diagonal(chol))) - 0.5 * n * np.log(2 * np.pi)

    def fit(self, x, y):
        x = np.asarray(x, dtype=float).ravel()
        y = np.asarray(y, dtype=float)
        self.y_mean_ = float(np.mean(y))
        self.y_std_ = float(np.std(y)) or 1.0
        yn = (y - self.y_mean_) / self.y_std_
        ls_grid = np.logspace(np.log10(self.length_scale_bounds[0]),
                              np.log10(self.length_scale_bounds[1]), self.n_grid)
        noise_grid = np.logspace(np.log10(self.noise_level_bounds[0]),
                                 np.log10(self.noise_level_bounds[1]), self.n_grid)
        per_grid = np.logspace(np.log10(self.periodicity_bounds[0]),
                               np.log10(self.periodicity_bounds[1]), self.n_grid) \
            if self.kernel_type in ("periodic", "locper") else [1.0]
        best, best_lml = None, -np.inf
        for ls in ls_grid:
            for nl in noise_grid:
                for per in per_grid:
                    params = {"length_scale": ls, "noise": nl, "periodicity": per}
                    lml = float(self._lml(x, yn, params))
                    if np.isfinite(lml) and lml > best_lml:
                        best, best_lml = params, lml
        self.params_ = best
        self.x_train_ = x
        self.chol_ = _cholesky(self._kernel(x, x, best) + best["noise"] * np.eye(x.shape[0]))
        self.alpha_ = sp_linalg.cho_solve((self.chol_, True), yn)
        return self

    def predict(self, x_new):
        x_new = np.asarray(x_new, dtype=float).ravel()
        mu = self._kernel(x_new, self.x_train_, self.params_) @ self.alpha_
        return mu * self.y_std_ + self.y_mean_

    def predict_matrix(self, x_new):
        """K* K^-1, the GP mean's linear smoothing operator (:130-137)."""
        k_star = self._kernel(np.asarray(x_new, dtype=float).ravel(), self.x_train_,
                              self.params_)
        k_inv = sp_linalg.cho_solve((self.chol_, True), np.eye(self.x_train_.shape[0]))
        return k_star @ k_inv


def estimate_background(x_meas, y_meas, y_pred, kernel_type="gaussian", **gp_kw):
    """A GP fitted to the residuals (measured - predicted) and its mean at
    the measured points (:140-145)."""
    gp = GPBackground(kernel_type=kernel_type, **gp_kw)
    resid = np.asarray(y_meas) - np.asarray(y_pred)
    gp.fit(x_meas, resid)
    return gp, gp.predict(x_meas)


def get_background_matrix(gps, times, y_drt=None, corr_power=None):
    """The background operator: the sum of the GPs' K* K^-1, scaled by
    (1 - corr) ** corr_power where it correlates with the model response
    ``y_drt`` (:148-162)."""
    rm = 0
    for gp in np.atleast_1d(gps):
        rm = rm + gp.predict_matrix(times)
    if corr_power is not None and y_drt is not None:
        y_drt = np.asarray(y_drt)
        bkg_est = rm @ y_drt
        denom = np.linalg.norm(bkg_est) * np.linalg.norm(y_drt)
        if denom > 0:
            corr = np.abs(np.dot(bkg_est, y_drt)) / denom
            rm = rm * (1 - corr) ** corr_power
    return rm


def estimate_chrono_background(drt, times, i_signal, v_signal, **kw):
    """The DRT and a GP fitted in turn to the residual drift, on a copy of
    ``drt`` (:165-171): (drt_bkg, [gp], y_bkg)."""
    return drt.estimate_chrono_background(times, i_signal, v_signal, copy_self=True, **kw)
