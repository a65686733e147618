"""Robust and adaptive N-D filters for the post-fit map pipeline.

Copy of ``hybdrt_tpu/filters/_filters.py:1-349`` (numpy/scipy.ndimage): the
moving robust statistics (``std_filter`` :26, ``iqr_filter`` :37), the ratio of
gaussians, the hysteresis thresholds (:91, :105), ``masked_filter`` (:120),
the iterative gaussian filter (:169) and the non-uniform and adaptive
gaussians (:192-337). They run on small host arrays assembled over the psi
grid.
"""
import numpy as np
from scipy import ndimage

from ._scifilters import empty_gaussian_filter1d, empty_gaussian_filter, gaussian_laplace1d


# ------------------------------------------------------------------
# Moving robust statistics (reference _filters.py:8-58)
# ------------------------------------------------------------------
def rms_filter(a, size, empty=False, **kw):
    a = np.asarray(a, dtype=float)
    a2_mean = ndimage.uniform_filter(a ** 2, size, **kw)
    if empty:
        n = size ** a.ndim if np.isscalar(size) else int(np.prod(size))
        a2_mean = (a2_mean - a ** 2 / n) * n / (n - 1)
    a2_mean = np.maximum(a2_mean, 0)
    return a2_mean ** 0.5


def std_filter(a, size, mask=None, **kw):
    a = np.asarray(a, dtype=float)
    if mask is None:
        a_mean = ndimage.uniform_filter(a, size, **kw)
        var = ndimage.uniform_filter((a - a_mean) ** 2, size, **kw)
    else:
        a_mean = masked_filter(a, mask, ndimage.uniform_filter, size=size, **kw)
        var = masked_filter((a - a_mean) ** 2, mask, ndimage.uniform_filter, size=size, **kw)
    return np.maximum(var, 0) ** 0.5


def iqr_filter(a, size, **kw):
    q1 = ndimage.percentile_filter(a, 25, size=size, **kw)
    q3 = ndimage.percentile_filter(a, 75, size=size, **kw)
    return q3 - q1


def gaussian_kernel_scale(sigma, truncate=4.0, empty=False):
    radius = int(float(sigma) * truncate + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    if empty:
        phi[x == 0] = 0
    return phi.sum()


# ------------------------------------------------------------------
# Ratio of gaussians (reference _filters.py:59-100)
# ------------------------------------------------------------------
def rog_filter(a, sigma_loc, sigma_glob, mask=None, median_pad=0.1, median_size=None,
               mode="reflect"):
    """Normalize local amplitude to a global scale: a * G_glob / G_loc."""
    a = np.asarray(a, dtype=float)
    if mask is not None:
        local_scale = masked_filter(a ** 2, mask, sigma=sigma_loc, mode=mode)
    else:
        local_scale = ndimage.gaussian_filter(a ** 2, sigma_loc, mode=mode)

    if median_size is not None:
        local_scale = local_scale + median_pad * ndimage.median_filter(
            local_scale, median_size, mode=mode)
    else:
        ref = np.median(a[mask > 0] ** 2) if mask is not None else np.median(a ** 2)
        local_scale = local_scale + median_pad * ref
    local_scale = local_scale ** 0.5

    if mask is not None:
        local_scale = np.nan_to_num(local_scale, nan=1)
        global_scale = np.exp(masked_filter(np.log(local_scale), mask, sigma=sigma_glob,
                                            mode=mode))
    else:
        global_scale = np.exp(ndimage.gaussian_filter(np.log(local_scale), sigma_glob,
                                                      mode=mode))
    scaled = a * global_scale / local_scale
    if mask is not None:
        out = scaled.copy()
        fill = masked_filter(scaled, mask, sigma=sigma_glob, mode=mode)
        out[mask == 0] = fill[mask == 0]
        return out
    return scaled


# ------------------------------------------------------------------
# Hysteresis thresholds (reference _filters.py:103-148)
# ------------------------------------------------------------------
def flexible_hysteresis_threshold(a, low, high, structure=None):
    """Keep low-threshold components connected to a high-threshold point."""
    if low >= high:
        raise ValueError("low must be less than high")
    a = np.asarray(a)
    low_mask = a > low
    high_mask = a > high
    labels, count = ndimage.label(low_mask, structure=structure)
    high_count = ndimage.sum_labels(high_mask.astype(float), labels,
                                    index=np.arange(count + 1))
    touches_high = high_count > 0
    return touches_high[labels]


def signed_hysteresis_threshold(a, low, high):
    """Hysteresis threshold applied to + and - parts separately."""
    a = np.asarray(a)
    thresh = np.zeros(a.shape, dtype=bool)
    for sign in (1, -1):
        a_sign = np.where(a * sign > 0, a * sign, 0.0)
        sign_thresh = flexible_hysteresis_threshold(a_sign, low, high)
        mask = a * sign > 0
        thresh[mask] = sign_thresh[mask]
    return thresh


# ------------------------------------------------------------------
# Masked / NaN-aware filtering (reference _filters.py:149-182)
# ------------------------------------------------------------------
def masked_filter(a, mask, filter_func=None, **filter_kw):
    """Normalized convolution: filter(a*m)/filter(m). Linear filters only."""
    a = np.asarray(a, dtype=float)
    if not filter_kw and filter_func is None:
        sigma = np.ones(a.ndim)
        sigma[-1] = 0
        filter_kw = {"sigma": sigma}
    if filter_func is None:
        filter_func = ndimage.gaussian_filter
    mask = np.asarray(mask, dtype=float)
    x_filt = filter_func(a * mask, **filter_kw)
    mask_filt = filter_func(mask, **filter_kw)
    with np.errstate(invalid="ignore", divide="ignore"):
        return x_filt / mask_filt


def nan_filter(a, filter_func, **filter_kw):
    mask = ~np.isnan(a)
    return masked_filter(np.nan_to_num(a), mask, filter_func, **filter_kw)


# ------------------------------------------------------------------
# Iterative outlier-downweighting gaussian filter (reference :183-260)
# ------------------------------------------------------------------
def iterate_gaussian_weights(a, init_weights=None, adaptive=False, iter=2, nstd=5,
                             dev_rms_size=5, nan_mask=None, **filter_kw):
    a = np.asarray(a, dtype=float)
    weights = np.ones(a.shape) if init_weights is None else np.asarray(init_weights,
                                                                       dtype=float)
    if nan_mask is not None:
        weights[nan_mask] = 0
    for _ in range(iter):
        if adaptive:
            sigmas = get_adaptive_sigmas(a, empty=True, weights=weights, **filter_kw)

            def filter_func(a_in, **kw):
                return adaptive_gaussian_filter(a_in, sigmas=sigmas, empty=True, **kw)
        else:
            filter_func = empty_gaussian_filter
        dev = a - masked_filter(a, weights, filter_func=filter_func, **filter_kw)
        dev = np.nan_to_num(dev)
        dev_rms = masked_filter(dev, weights, rms_filter, size=dev_rms_size, empty=True)
        dev_rms = np.nan_to_num(dev_rms)
        weights = np.exp(-(dev / (nstd * dev_rms + 0.1 * np.std(dev) + 1e-15)) ** 6)
        if nan_mask is not None:
            weights[nan_mask] = 0
    return weights


def iterative_gaussian_filter(a, adaptive=False, iter=2, nstd=5, dev_rms_size=5,
                              nan_mask=None, fill_nans=False, **filter_kw):
    """Gaussian smoothing with iteratively downweighted outliers."""
    a = np.asarray(a, dtype=float)
    weights = iterate_gaussian_weights(a, None, adaptive, iter, nstd,
                                       dev_rms_size=dev_rms_size, nan_mask=nan_mask,
                                       **filter_kw)
    if adaptive:
        sigmas = get_adaptive_sigmas(a, empty=False, weights=weights, **filter_kw)

        def filter_func(a_in, **kw):
            return adaptive_gaussian_filter(a_in, sigmas=sigmas, **kw)
    else:
        filter_func = ndimage.gaussian_filter
    out = masked_filter(a, weights, filter_func=filter_func, **filter_kw)
    if nan_mask is not None and not fill_nans:
        out[nan_mask] = np.nan
    return out


# ------------------------------------------------------------------
# Nonuniform-sigma gaussian filter (reference _filters.py:261-361)
# ------------------------------------------------------------------
def nonuniform_gaussian_filter1d(a, sigma, axis=-1, empty=False, mode="reflect",
                                 cval=0.0, truncate=4, order=0, sigma_node_factor=1.5,
                                 min_sigma=0.25):
    """Per-pixel-sigma gaussian filter: filter at a ladder of sigma nodes and
    log-interpolate between the node outputs at each pixel."""
    a = np.asarray(a, dtype=float)
    sigma = np.asarray(sigma, dtype=float)
    if np.max(sigma) <= 0:
        return a
    sigma = np.maximum(sigma, 1e-8)

    min_ls = max(np.min(np.log10(sigma)), np.log10(min_sigma))
    max_ls = max(np.max(np.log10(sigma)), np.log10(min_sigma))
    num_nodes = int(np.ceil((max_ls - min_ls) / np.log10(sigma_node_factor))) + 1
    sigma_nodes = np.logspace(min_ls, max_ls, num_nodes)

    if np.min(sigma) < min_sigma:
        factor = sigma_nodes[-1] / sigma_nodes[-2] if len(sigma_nodes) > 1 \
            else sigma_node_factor
        sigma = np.maximum(sigma, min_sigma / factor ** 2)
        while sigma_nodes[0] > np.min(sigma) * 1.001:
            sigma_nodes = np.insert(sigma_nodes, 0, sigma_nodes[0] / factor)

    node_delta = np.log(sigma_nodes[-1] / sigma_nodes[-2]) if len(sigma_nodes) > 1 else 1.0

    node_outputs = np.empty((len(sigma_nodes), *a.shape), dtype=a.dtype)
    for i, s_node in enumerate(sigma_nodes):
        if s_node < min_sigma:
            node_outputs[i] = empty_gaussian_filter1d(
                a, sigma=min_sigma, axis=axis, mode=mode, cval=cval, truncate=truncate,
                order=order) if empty else a
        elif empty:
            node_outputs[i] = empty_gaussian_filter1d(
                a, sigma=s_node, axis=axis, mode=mode, cval=cval, truncate=truncate,
                order=order)
        else:
            node_outputs[i] = ndimage.gaussian_filter1d(
                a, sigma=s_node, axis=axis, mode=mode, cval=cval, truncate=truncate,
                order=order)

    # Triangular interpolation weights in log-sigma space
    log_ratio = np.abs(np.log(sigma[None, ...] / sigma_nodes.reshape(
        (-1,) + (1,) * a.ndim))) / node_delta
    node_weights = np.clip(1 - log_ratio, 0, None)
    return np.sum(node_outputs * node_weights, axis=0)


def nonuniform_gaussian_filter(a, sigma, empty=False, mode="reflect", cval=0.0,
                               truncate=4, order=0, sigma_node_factor=1.5):
    out = np.asarray(a, dtype=float)
    for axis in range(out.ndim):
        out = nonuniform_gaussian_filter1d(out, sigma[axis], axis, empty, mode, cval,
                                           truncate, order, sigma_node_factor)
    return out


# ------------------------------------------------------------------
# Curvature-adaptive sigma (reference _filters.py:363-505)
# ------------------------------------------------------------------
def get_adaptive_sigma1d(a, axis=-1, presmooth_sigma=1, empty=False, weights=None,
                         curv_func=None, curv_kw=None, k_factor=1.0, max_sigma=5.0,
                         mode="reflect", cval=0.0, truncate=4.0):
    """Per-pixel sigma inversely related to normalized local curvature."""
    a = np.asarray(a, dtype=float)
    if max_sigma <= 0:
        return np.zeros_like(a)
    if curv_kw is None:
        curv_kw = {"curv_sigma": 1, "mode": mode, "cval": cval, "truncate": truncate} \
            if curv_func is None else {}
    if curv_func is None:
        def curv_func(a_in, curv_sigma=None, **kw):
            return gaussian_laplace1d(a_in, sigma=curv_sigma, axis=axis, **kw)

    filter_func = empty_gaussian_filter if empty else ndimage.gaussian_filter
    if np.isscalar(presmooth_sigma):
        presmooth_sigma = [presmooth_sigma] * a.ndim
    if np.max(presmooth_sigma) > 0:
        if weights is None:
            a_smooth = filter_func(a, sigma=presmooth_sigma, mode=mode, cval=cval,
                                   truncate=truncate)
        else:
            a_smooth = masked_filter(a, weights, filter_func, sigma=presmooth_sigma,
                                     mode=mode, cval=cval, truncate=truncate)
            a_smooth = np.nan_to_num(a_smooth)
    else:
        a_smooth = a

    curv = curv_func(a_smooth, **curv_kw)
    curv = curv / (np.abs(a_smooth) + np.std(a_smooth) + 1e-15)
    if np.std(curv) == 0:
        return np.ones(a.shape) * max_sigma
    curv = curv / np.std(curv)
    curv = ndimage.gaussian_filter(np.abs(curv), presmooth_sigma)
    c = k_factor / max_sigma ** 2
    return (k_factor / (np.abs(curv) + c)) ** 0.5


def get_adaptive_sigmas(a, presmooth_sigma=None, empty=False, weights=None,
                        curv_func=None, curv_kw=None, k_factor=1.0, max_sigma=1.0,
                        mode="reflect", cval=0.0, truncate=4.0):
    ndim = np.ndim(a)
    if np.isscalar(k_factor):
        k_factor = [k_factor] * ndim
    if np.isscalar(max_sigma):
        max_sigma = [max_sigma] * ndim
    if presmooth_sigma is None:
        presmooth_sigma = max_sigma
    return [get_adaptive_sigma1d(a, axis, presmooth_sigma, empty, weights, curv_func,
                                 curv_kw, k_factor[axis], max_sigma[axis], mode, cval,
                                 truncate)
            for axis in range(ndim)]


def adaptive_gaussian_filter1d(a, sigma=None, axis=-1, presmooth_sigma=1, empty=False,
                               curv_func=None, curv_kw=None, k_factor=1, max_sigma=1.0,
                               mode="reflect", cval=0.0, truncate=4, order=0,
                               sigma_node_factor=1.5):
    if sigma is None:
        sigma = get_adaptive_sigma1d(a, axis, presmooth_sigma, empty, None, curv_func,
                                     curv_kw, k_factor, max_sigma, mode, cval, truncate)
    return nonuniform_gaussian_filter1d(a, sigma, axis, empty, mode, cval, truncate,
                                        order, sigma_node_factor)


def adaptive_gaussian_filter(a, sigmas=None, presmooth_sigma=None, empty=False,
                             curv_func=None, curv_kw=None, k_factor=1, max_sigma=5,
                             mode="reflect", cval=0.0, truncate=4, order=0,
                             sigma_node_factor=1.5):
    ndim = np.ndim(a)
    if np.isscalar(k_factor):
        k_factor = [k_factor] * ndim
    if np.isscalar(max_sigma):
        max_sigma = [max_sigma] * ndim
    if sigmas is None:
        sigmas = [None] * ndim
    if presmooth_sigma is None:
        presmooth_sigma = max_sigma
    out = np.asarray(a, dtype=float)
    for axis in range(ndim):
        if max_sigma[axis] > 0:
            out = adaptive_gaussian_filter1d(out, sigmas[axis], axis, presmooth_sigma,
                                             empty, curv_func, curv_kw, k_factor[axis],
                                             max_sigma[axis], mode, cval, truncate,
                                             order, sigma_node_factor)
    return out


def apply_filter(x_in, filter_func=None, filter_kw=None):
    if filter_kw is None:
        if filter_func is None:
            sigma = np.ones(np.ndim(x_in))
            sigma[-1] = 0
            filter_kw = {"sigma": sigma}
        else:
            filter_kw = {}
    if filter_func is None:
        filter_func = ndimage.gaussian_filter
    return filter_func(x_in, **filter_kw)
