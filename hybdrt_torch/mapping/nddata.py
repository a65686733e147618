"""N-D raw-data QC: assemble measured signals over psi, flag outlier points
and bad observations.

Copy of ``hybdrt_tpu/mapping/nddata.py:1-130`` (numpy/scipy):
``assemble_nddata`` (:12), ``impute_nans`` (:30), ``flag_outliers`` (:56),
``factor_correction`` (:75), ``offset_correction`` (:86) and
``flag_bad_obs`` (:91).
"""
import numpy as np
from scipy import ndimage

from ..utils.eis import complex_vector_to_concat
from ..utils.stats import robust_std
from ..filters import iqr_filter, std_filter, masked_filter
from . import ndx


def assemble_nddata(data_list, psi, psi_dim_names, sort_by=None, group_by=None,
                    sort_dim_grids=None, sort_dim_dist_thresh=None, impute=False):
    """Stack per-observation signal vectors and assemble over the psi grid.

    data_list: list of equal-length 1-D arrays (complex z is converted to
    concatenated [Re; Im]). Returns (dim_grid_values, ndy)."""
    lengths = {len(np.atleast_1d(d)) for d in data_list}
    if len(lengths) != 1:
        raise ValueError("All observations must have equal data length for ND assembly")
    y_arr = np.stack([np.atleast_1d(d) for d in data_list])
    if np.iscomplexobj(y_arr):
        y_arr = complex_vector_to_concat(y_arr, axis=-1)
    return ndx.assemble_ndx(y_arr, psi, psi_dim_names, tau=np.arange(y_arr.shape[-1]),
                            sort_by=sort_by, group_by=group_by,
                            sort_dim_grids=sort_dim_grids,
                            sort_dim_dist_thresh=sort_dim_dist_thresh, impute=impute)


def impute_nans(ndy, method="filter", filter_func=None, **filter_kw):
    """Fill NaNs with normalized-convolution filtered values
    (reference nddata.py:135-150)."""
    if method != "filter":
        raise ValueError(f"Imputation method {method} not implemented")
    nan_index = np.isnan(ndy)
    mask = (~nan_index).astype(float)
    y_filt = masked_filter(np.nan_to_num(ndy), mask, filter_func=filter_func, **filter_kw)
    out = np.array(ndy, copy=True)
    out[nan_index] = y_filt[nan_index]
    return out


def outlier_prob(y, mu_in, sigma_in, sigma_out, p_prior):
    """Posterior outlier probability under a two-component gaussian model
    (reference preprocessing.py:860-876)."""
    pdf_in = np.exp(-0.5 * (y - mu_in) ** 2 / sigma_in ** 2) / sigma_in
    pdf_out = np.exp(-0.5 * (y - mu_in) ** 2 / sigma_out ** 2) / sigma_out
    denom = (1 - p_prior) * pdf_in + p_prior * pdf_out
    with np.errstate(invalid="ignore", divide="ignore"):
        p_out = p_prior * pdf_out / denom
    # Deviations smaller than the inlier spread are never outliers
    p_out[np.abs(y - mu_in) <= sigma_in] = 0
    return p_out


def flag_outliers(ndy, filter_size, thresh=0.9, p_prior=0.01,
                  full_std_contribution=0.05, impute=True, impute_kw=None):
    """Flag points with high posterior outlier probability vs the local
    median/IQR (reference nddata.py:152-176)."""
    ndy = np.asarray(ndy, dtype=float)
    if impute and np.any(np.isnan(ndy)):
        impute_kw = impute_kw or {"sigma": 0.5}
        y_filt = impute_nans(ndy, **impute_kw)
    else:
        y_filt = ndy
    mu_in = ndimage.median_filter(y_filt, filter_size)
    sigma_in = iqr_filter(y_filt, size=filter_size) / 1.349
    sigma_in = sigma_in + full_std_contribution * robust_std(
        np.nan_to_num(y_filt, nan=np.nanmedian(y_filt))) + 1e-8
    sigma_out = np.abs(ndy - mu_in) + 1e-8
    p_out = np.nan_to_num(outlier_prob(ndy, mu_in, sigma_in, sigma_out, p_prior))
    return p_out > thresh


def factor_correction(x_raw, x_filt, x_floor=1e-6):
    """Best per-observation multiplicative correction to the filtered values
    (reference nddata.py:298-333)."""
    x_raw = np.asarray(x_raw, dtype=float)
    x_filt = np.asarray(x_filt, dtype=float)
    num = np.nansum(np.abs(x_raw * x_filt), axis=-1)
    den = np.nansum(x_filt ** 2, axis=-1)
    factor = num / np.maximum(den, x_floor)
    return factor


def offset_correction(x_raw, x_filt):
    """Best per-observation additive correction (reference nddata.py:335-358)."""
    return np.nanmean(np.asarray(x_raw) - np.asarray(x_filt), axis=-1)


def flag_bad_obs(x_raw, x_filt, std_size=5, thresh=2, test_factor_correction=False,
                 test_offset_correction=False, return_rss=False, use_robust_std=True):
    """Flag observations whose deviation from the local-filtered map exceeds
    thresh x the local spread (reference nddata.py:178-296)."""
    x_raw_list = x_raw if isinstance(x_raw, (list, tuple)) else [x_raw]
    x_filt_list = x_filt if isinstance(x_filt, (list, tuple)) else [x_filt]

    bad_flags, rss_list = [], []
    for xri, xfi in zip(x_raw_list, x_filt_list):
        xri = np.asarray(xri, dtype=float)
        xfi = np.asarray(xfi, dtype=float)
        xfi_tmp = np.where(np.isnan(xfi), np.nanmedian(xfi), xfi)
        if use_robust_std:
            x_std = iqr_filter(xfi_tmp, size=std_size) / 1.349
            x_std = x_std + 0.1 * robust_std(xfi[~np.isnan(xfi)])
        else:
            x_std = std_filter(xfi_tmp, size=std_size)
        x_std = x_std + 1e-12

        def rss_of(xr):
            dev = (xr - xfi) / x_std
            return np.nanmean(dev ** 2, axis=-1)

        rss = rss_of(xri)
        if test_factor_correction:
            factor = factor_correction(xri, xfi)
            rss = np.minimum(rss, rss_of(xri / np.expand_dims(
                np.maximum(factor, 1e-12), -1)))
        if test_offset_correction:
            offset = offset_correction(xri, xfi)
            rss = np.minimum(rss, rss_of(xri - np.expand_dims(offset, -1)))
        rss_list.append(rss)
        bad_flags.append(rss >= thresh)  # reference threshold semantics

    bad_index = bad_flags[0]
    for bf in bad_flags[1:]:
        bad_index = bad_index | bf
    if return_rss:
        return bad_index, rss_list
    return bad_index
