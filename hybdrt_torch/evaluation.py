"""Accuracy of a fit against data (counterpart of ``hybdrt_tpu/evaluation.py``):
``chi_sq`` (:23), the only metric the port's ``DRT`` calls. Host numpy."""
import numpy as np


def chi_sq(y_true, y_est, weights=None):
    """Mean squared weighted residual; a complex residual is stacked
    [Re; Im], its weights too (real weights are used for both parts)."""
    y_true = np.asarray(y_true)
    y_est = np.asarray(y_est)
    resid = y_est - y_true
    if np.iscomplexobj(resid):
        resid = np.concatenate([resid.real, resid.imag])
        if weights is not None and np.iscomplexobj(weights):
            weights = np.concatenate([weights.real, weights.imag])
        elif weights is not None:
            weights = np.tile(weights, 2)
    if weights is None:
        weights = np.ones_like(resid)
    return np.sum((resid * weights) ** 2) / len(resid)
