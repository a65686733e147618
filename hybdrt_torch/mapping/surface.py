"""Ridge/trough surfaces across N-D DRT maps.

Copy of ``hybdrt_tpu/mapping/surface.py:1-276`` (numpy/scipy). Identifies peak
(ridge) and trough trajectories through stacks of DRT rows by combining
curvature/height posteriors with hysteresis thresholds and ridge repulsion:
``peak_prob`` (:36), ``trough_prob`` (:61), ``find_ridges*`` (:79-95),
``find_troughs*`` (:98-202), ``ridge_repulsion`` (:125), ``coef_to_ridges``
(:140), ``integrate_ridges*`` (:205-243) and ``ridge_prob`` (:246). The
derivative eval matrices come from the port's ``ops/basis.py``, built in
numpy where the JAX package builds them with jnp on the CPU.
"""
import numpy as np
from scipy import signal, ndimage

from . import ndx
from ..filters import std_filter, flexible_hysteresis_threshold


from ..ops.basis import func_eval_matrix_host


# ------------------------------------------------------------------
# Probability maps
# ------------------------------------------------------------------
def _field_stds(f, fx, fxx, f_var, fx_var, fxx_var, std_size, std_baseline):
    """Per-field uncertainty: Bayesian variances when given, otherwise a local
    std filter plus a global baseline (reference surface.py:265-333)."""
    nan_mask = np.isnan(f)
    out = []
    for arr, var in ((f, f_var), (fx, fx_var), (fxx, fxx_var)):
        if var is None:
            std = std_filter(np.nan_to_num(arr), std_size,
                             mask=(~nan_mask).astype(float))
            std = std + std_baseline * np.std(arr[~nan_mask]) + 1e-12
        else:
            std = np.asarray(var, dtype=float) ** 0.5 + 1e-12
        out.append(std)
    return out


def peak_prob(f, fx, fxx, std_size=5, f_var=None, fx_var=None, fxx_var=None,
              constrain_sign=False, std_baseline=0.1):
    """P(peak) per pixel: curvature opposing the function sign, slope near
    zero, and height clear of zero (reference surface.py:265-309). Variance
    arrays from a Bayesian inversion may be supplied in place of the local
    std estimate."""
    from scipy.special import ndtr
    f = np.asarray(f, dtype=float)
    fx = np.asarray(fx, dtype=float)
    fxx = np.asarray(fxx, dtype=float)
    f_std, fx_std, fxx_std = _field_stds(f, fx, fxx, f_var, fx_var, fxx_var,
                                         std_size, std_baseline)
    # P(curvature has sign opposite the function)
    if constrain_sign:
        fxx_prob = 1 - 2 * ndtr((0 - (-np.sign(f) * fxx)) / fxx_std)
        fxx_prob = np.clip(fxx_prob, 0, None)
    else:
        fxx_prob = 1 - ndtr((0 - (-np.sign(f) * fxx)) / fxx_std)
    # P(slope within 5 std of zero)
    fx_prob = ndtr((5 * fx_std - fx) / fx_std) - ndtr((-5 * fx_std - fx) / fx_std)
    # P(height more than 1 std from zero)
    f_prob = 1 - ndtr((f_std - np.abs(f)) / f_std)
    return f_prob * fx_prob * fxx_prob


def trough_prob(f, fx, fxx, f_var=None, fx_var=None, fxx_var=None, std_size=5,
                std_baseline=0.1):
    """P(trough): slope near zero with curvature matching the function sign
    (reference surface.py:312-350)."""
    from scipy.special import ndtr
    f = np.asarray(f, dtype=float)
    fx = np.asarray(fx, dtype=float)
    fxx = np.asarray(fxx, dtype=float)
    f_std, fx_std, fxx_std = _field_stds(f, fx, fxx, f_var, fx_var, fxx_var,
                                         std_size, std_baseline)
    fx_prob = ndtr((5 * fx_std - fx) / fx_std) - ndtr((-5 * fx_std - fx) / fx_std)
    fxx_prob = 1 - ndtr((0 - np.sign(f) * fxx) / fxx_std)
    return fx_prob * fxx_prob


# ------------------------------------------------------------------
# Ridge finding (reference surface.py:12-29)
# ------------------------------------------------------------------
def find_ridges_2d(p_ridge, distance=3, height=0.1, prominence=0.1, **kw):
    """Row-wise peak finding on a (psi, tau) probability image."""
    p_ridge = np.asarray(p_ridge, dtype=float)
    ridge_mask = np.zeros_like(p_ridge, dtype=bool)
    for i in range(p_ridge.shape[0]):
        peaks, _ = signal.find_peaks(p_ridge[i], distance=distance, height=height,
                                     prominence=prominence, **kw)
        ridge_mask[i, peaks] = True
    return ridge_mask


def find_ridges(p_ridge, num_group_dims, **kw):
    ridge_mask = ndx.filter_ndx(np.asarray(p_ridge, dtype=float), num_group_dims,
                                mask_nans=False, by_group=True,
                                filter_func=lambda a, **k: find_ridges_2d(a, **k).astype(float),
                                **kw)
    return np.nan_to_num(ridge_mask).astype(bool)


def find_troughs_1d(ridge_mask, f, p_trough):
    """Place a trough between each adjacent ridge pair: at the max trough
    probability for same-sign ridges, or at the zero crossing of f when the
    ridges have opposite sign (series_neg / unconstrained fits)
    (reference surface.py:54-130)."""
    from ..utils.array import nearest_index
    ridge_mask = np.asarray(ridge_mask, dtype=bool)
    f = np.asarray(f)
    trough_mask = np.zeros_like(ridge_mask)
    peaks = np.where(ridge_mask)[0]
    for i in range(len(peaks) - 1):
        start, end = peaks[i], peaks[i + 1]
        if end <= start + 1:
            continue
        if np.sign(f[start]) == np.sign(f[end]):
            trough = start + 1 + int(np.argmax(p_trough[start + 1:end]))
        else:
            trough = start + nearest_index(f[start:end], 0)
        trough_mask[trough] = True
    return trough_mask


def find_troughs_2d(ridge_mask, f, p_trough):
    return np.stack([find_troughs_1d(ridge_mask[i], f[i], p_trough[i])
                     for i in range(ridge_mask.shape[0])], axis=0)


def ridge_repulsion(ridge_mask, p_trough, distance=2):
    """Suppress trough probability near ridges (reference surface.py:300-330)."""
    structure = np.ones((1,) * (ridge_mask.ndim - 1) + (2 * distance + 1,))
    near_ridge = ndimage.binary_dilation(ridge_mask, structure=structure)
    out = np.array(p_trough, copy=True)
    out[near_ridge] = 0
    return out


def ridge_prob_filter(p_ridge, num_group_dims, sigma=1.0):
    """Smooth ridge probability along the psi axes only."""
    sigma_vec = [sigma] * (p_ridge.ndim - 1) + [0]
    return ndimage.gaussian_filter(np.nan_to_num(p_ridge), sigma=sigma_vec)


def coef_to_ridges(x, drtmd, num_group_dims, normalize=True, ndx_filter=True,
                   filter_kw=None, std_size=5, std_baseline=0.1,
                   ridge_repulse_distance=2, hysteresis_threshold=True,
                   thresh_low=0.2, thresh_high=0.75, find_ridges_kw=None):
    """Full pipeline: coefficient maps -> ridge + trough masks
    (reference surface.py:150-330, simplified: no sato/meijering filters)."""
    x = np.asarray(x, dtype=float)
    if find_ridges_kw is None:
        find_ridges_kw = {}
    if normalize:
        x_sum = np.nansum(np.abs(x), axis=-1)
        x_sum[x_sum == 0] = 1
        x_norm = x / x_sum[..., None]
    else:
        x_norm = x

    def eval_order(order):
        em = func_eval_matrix_host(np.log(drtmd.tau_supergrid), None,
                                   drtmd.tau_basis_type,
                                   drtmd.tau_epsilon, order)
        return x_norm @ em.T

    f = eval_order(0)
    fx = eval_order(1)
    fxx = eval_order(2)

    cp = peak_prob(f, fx, fxx, std_size=std_size, std_baseline=std_baseline)
    tp = trough_prob(f, fx, fxx, std_size=std_size, std_baseline=std_baseline)
    p_ridge = cp * (1 - tp)
    p_trough = tp * (1 - cp)

    if ndx_filter:
        if filter_kw is None:
            filter_kw = dict(iterative=True, iter=2, nstd=5, impute=False,
                             by_group=False, sigma=(1,) * (x.ndim - 1) + (0,))
        p_ridge = np.nan_to_num(ndx.filter_ndx(p_ridge, num_group_dims, **filter_kw))
        p_trough = np.nan_to_num(ndx.filter_ndx(p_trough, num_group_dims, **filter_kw))

    if hysteresis_threshold:
        mask = flexible_hysteresis_threshold(p_ridge, thresh_low, thresh_high)
        p_ridge = np.where(mask, p_ridge, 0)

    ridge_mask = find_ridges_2d(p_ridge.reshape(-1, p_ridge.shape[-1]),
                                **find_ridges_kw).reshape(p_ridge.shape)
    if ridge_repulse_distance > 0:
        p_trough = ridge_repulsion(ridge_mask, p_trough, ridge_repulse_distance)
    trough_mask = find_troughs_2d(ridge_mask.reshape(-1, ridge_mask.shape[-1]),
                                  f.reshape(-1, f.shape[-1]),
                                  p_trough.reshape(-1, p_trough.shape[-1]))
    trough_mask = trough_mask.reshape(ridge_mask.shape)
    return ridge_mask, trough_mask, p_ridge, p_trough


def find_troughs(ridge_mask, f, p_trough, num_group_dims=0):
    """Trough masks for arbitrarily-grouped maps: apply find_troughs_2d to
    each leading-group (psi, tau) slab (reference surface.py)."""
    ridge_mask = np.asarray(ridge_mask)
    if num_group_dims == 0:
        return find_troughs_2d(ridge_mask, f, p_trough)
    out = np.zeros_like(ridge_mask)
    for idx in np.ndindex(*ridge_mask.shape[:num_group_dims]):
        out[idx] = find_troughs_2d(ridge_mask[idx], f[idx], p_trough[idx])
    return out


def integrate_ridges_1d(x, ridge_mask, trough_mask, tau=None,
                        epsilon_factor=1.25, max_epsilon=1.25,
                        epsilon_uniform=None):
    """Per-ridge area of a 1-D distribution slice: split x among the ridge
    peaks with RBF weighting bounded by the troughs, and record each peak's
    total mass at its ridge index (reference surface.py)."""
    from .. import peaks as peaks_mod
    x = np.asarray(x, dtype=float)
    if tau is None:
        tau = np.logspace(0, (len(x) - 1) * 0.1, len(x))
    peak_idx = np.where(ridge_mask)[0]
    area = np.zeros(len(x))
    if len(peak_idx) == 0:
        return area
    weights = peaks_mod.estimate_peak_weight_distributions(
        tau, x, None, peak_idx, basis_tau=tau,
        trough_indices=np.where(trough_mask)[0],
        epsilon_factor=epsilon_factor, max_epsilon=max_epsilon,
        epsilon_uniform=epsilon_uniform)
    area[peak_idx] = np.sum(x[None, :] * weights, axis=1)
    return area


def integrate_ridges_2d(x, ridge_mask, trough_mask, **kw):
    """Row-wise integrate_ridges_1d over a (psi, tau) map."""
    return np.stack([integrate_ridges_1d(x[i], ridge_mask[i], trough_mask[i],
                                         **kw) for i in range(len(x))])


def integrate_ridges(x, ridge_mask, trough_mask, num_group_dims=0, **kw):
    """Grouped integrate_ridges_2d (reference surface.py)."""
    x = np.asarray(x, dtype=float)
    if num_group_dims == 0:
        return integrate_ridges_2d(x, ridge_mask, trough_mask, **kw)
    out = np.zeros(np.shape(ridge_mask))
    for idx in np.ndindex(*x.shape[:num_group_dims]):
        out[idx] = integrate_ridges_2d(x[idx], ridge_mask[idx],
                                       trough_mask[idx], **kw)
    return out


def ridge_prob(f, fx, fxx, num_group_dims, subtract_troughs=True,
               std_baseline=0.1, std_size=5, ridge_filter=False,
               ndx_filter=True, filter_kw=None, hysteresis_threshold=True,
               thresh_low=0.2, thresh_high=0.75):
    """End-to-end ridge probability field: peak probability minus trough
    probability, ndx-filtered, with signed hysteresis cleanup
    (reference surface.py:403)."""
    from ..filters import signed_hysteresis_threshold
    from . import ndx as ndx_mod
    rp = peak_prob(f, fx, fxx, std_size=std_size, std_baseline=std_baseline)
    if ndx_filter and filter_kw is None:
        filter_kw = dict(iterative=True, iter=3, nstd=5, dev_rms_size=5,
                         adaptive=True, impute=True, impute_groups=True,
                         max_sigma=(1,) * num_group_dims + (0.5, 0),
                         k_factor=4, presmooth_sigma=None, mode="nearest")
    if ridge_filter:
        rp = ridge_prob_filter(rp, num_group_dims)
    if subtract_troughs:
        tp = trough_prob(f, fx, fxx, std_baseline=std_baseline,
                         std_size=std_size)
        if ridge_filter:
            tp = ridge_prob_filter(tp, num_group_dims)
        rp = rp - tp
    if ndx_filter:
        rp = ndx_mod.filter_ndx(rp, num_group_dims, **filter_kw)
    if hysteresis_threshold:
        rp = np.where(rp < 0, 0.0, rp)
        thresh = signed_hysteresis_threshold(rp * np.sign(f), thresh_low,
                                             thresh_high)
        rp = np.where(thresh, rp, 0.0)
    return rp
