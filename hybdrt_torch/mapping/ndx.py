"""N-D assembly and filtering of per-observation parameter arrays.

Copy of ``hybdrt_tpu/mapping/ndx.py:1-245`` (numpy/scipy): ``resample`` (:16),
``segment_dimension`` (:46), ``assemble_ndx`` (:76), ``group_nn_count``
(:179) and ``filter_ndx`` (:193) map the flat (observation x parameter)
result arrays onto dense N-D arrays over the psi grid for image-style
post-processing. ``segment_dimension`` is written here in numpy (a gaussian
kernel density of the gaps on a 1-D grid, and 1-D DBSCAN over the sorted
values), where the JAX package calls scikit-learn's ``KernelDensity`` and
``DBSCAN``, which the GPU machine lacks.
"""
import numpy as np
from scipy import ndimage, signal, interpolate
from scipy.spatial.distance import cdist

from ..utils.array import rel_round
from ..filters import (iterative_gaussian_filter, adaptive_gaussian_filter,
                       masked_filter, get_adaptive_sigmas)


def resample(psi, psi_meas, x_meas, interp_class=None, interp_kw=None,
             remove_invariant=True):
    """Interpolate x over psi coordinates (reference ndx.py:28-69)."""
    psi_meas = np.atleast_2d(psi_meas)
    psi = np.atleast_2d(psi)
    if remove_invariant:
        dim_index = np.std(psi_meas, axis=0) > 1e-8
    else:
        dim_index = np.ones(psi.shape[1], dtype=bool)
    psi_meas_eff = psi_meas[:, dim_index]
    psi_eff = psi[:, dim_index]
    ndim = int(np.sum(dim_index))

    if ndim == 1:
        if interp_kw is None:
            interp_kw = {"axis": 0} if interp_class is None else {}
        if interp_class is None:
            interp_class = interpolate.interp1d
        psi_eff = psi_eff.flatten()
        psi_meas_eff = psi_meas_eff.flatten()
    else:
        if interp_kw is None:
            interp_kw = {"rescale": True} if interp_class is None else {}
        if interp_class is None:
            interp_class = interpolate.LinearNDInterpolator

    interp_func = interp_class(psi_meas_eff, x_meas, **interp_kw)
    return interp_func(psi_eff)


def _gaussian_kde_log_density(samples, x, bandwidth):
    """Log density at x of a gaussian kernel density estimate over the 1-D
    samples, in the arithmetic of scikit-learn's ``KernelDensity(kernel=
    "gaussian", bandwidth=...).fit(samples[:, None]).score_samples(x[:,
    None])`` on one tree leaf (up to 40 samples): each log kernel
    -0.5 d^2 / h^2 at d = sqrt((x - s)^2), accumulated in sample order by
    a + log(exp(u - a) + exp(v - a)), a = max(u, v), then the kernel's norm
    added and log N taken off. The same values and rounding make the same
    grid point win where two are equal up to rounding."""
    dist = np.sqrt((x[:, None] - samples[None, :]) ** 2)
    log_k = -0.5 * (dist * dist) / (bandwidth * bandwidth)
    acc = log_k[:, 0]
    for v in log_k[:, 1:].T:
        a = np.fmax(acc, v)
        with np.errstate(invalid="ignore"):
            acc = np.where(a == -np.inf, -np.inf, a + np.log(np.exp(acc - a) + np.exp(v - a)))
    log_knorm = -(0.5 * np.log(2 * np.pi)) - np.log(bandwidth)
    return (acc + log_knorm) - np.log(len(samples))


def _radius_neighbors_1d(a, eps):
    """(n, n) bool: a[j] is within eps of a[i], decided as scikit-learn's
    ``NearestNeighbors(radius=eps)`` decides it for DBSCAN on 1-D data, so
    that a gap equal to eps up to rounding falls on the same side: by brute
    force through |a|^2 - 2 a.b + |b|^2 up to 11 values, and through a
    KD-tree's (a - b)^2 above (scikit-learn's choice for its default five
    neighbours); either squared distance against eps^2."""
    if len(a) <= 11:
        sq = a ** 2
        d2 = np.maximum(sq[:, None] + (-2.0 * (a[:, None] * a[None, :])) + sq[None, :], 0.0)
    else:
        d2 = (a[:, None] - a[None, :]) ** 2
    return d2 <= eps * eps


def _dbscan_1d(a, eps, min_samples):
    """Cluster labels of the values a, -1 for noise: scikit-learn's DBSCAN
    (core points have at least min_samples neighbours within eps, themselves
    included; clusters grow from the core points in index order, and a
    border point joins the first cluster that reaches it)."""
    neighbours = _radius_neighbors_1d(a, eps)
    is_core = neighbours.sum(axis=1) >= min_samples
    labels = np.full(len(a), -1)
    label = 0
    for i in range(len(a)):
        if labels[i] != -1 or not is_core[i]:
            continue
        stack = [i]
        while stack:
            v = stack.pop()
            if labels[v] != -1:
                continue
            labels[v] = label
            if is_core[v]:
                stack.extend(u for u in np.flatnonzero(neighbours[v]) if labels[u] == -1)
        label += 1
    return labels


def segment_dimension(a, min_samples=3, return_distance_thresh=False):
    """Cluster a psi dimension's values into grid levels via gap-density
    clustering (reference ndx.py:395-436, DBSCAN over 1-D values)."""
    a = np.unique(a)
    diffs = np.diff(a)
    if len(diffs) == 0:
        result = a
        return (result, 1.0) if return_distance_thresh else result
    bw = max(np.percentile(diffs, 99) / 20, 1e-12)
    x = np.linspace(np.min(diffs), np.max(diffs), 1000)
    density = _gaussian_kde_log_density(diffs, x, bw)
    first_peak = signal.argrelextrema(density, np.greater_equal)[0][0]
    troughs = signal.argrelextrema(density[first_peak:], np.less_equal)[0]
    d_cluster = x[troughs[0] + first_peak] if len(troughs) else np.max(diffs)

    group_idx = _dbscan_1d(a, max(d_cluster, 1e-12), min_samples)
    cluster_means = [np.mean(a[group_idx == g]) for g in np.unique(group_idx) if g > -1]
    if not cluster_means:
        cluster_means = list(a)
    result = np.sort(cluster_means)
    if return_distance_thresh:
        return result, d_cluster
    return result


def assemble_ndx(x, psi, psi_dim_names, tau, sort_by=None, group_by=None,
                 psi_precision=8, sort_dim_grids=None, sort_dim_dist_thresh=None,
                 impute=False):
    """Assemble an N-D array over (group dims..., sort dims..., tau) from flat
    per-observation arrays (reference ndx.py:71-258).

    Returns (dim_grid_values, x_out); unmeasured grid points are NaN unless
    impute=True (nearest-neighbor fill).
    """
    x = np.asarray(x)
    psi = rel_round(np.asarray(psi, dtype=float), psi_precision)
    sort_by = sort_by or []
    group_by = group_by or []
    sort_dim_grids = sort_dim_grids or [None] * len(sort_by)
    sort_dim_dist_thresh = sort_dim_dist_thresh or [None] * len(sort_by)

    shape, dim_grid_values = [], []
    for dim in group_by:
        unique_vals = np.unique(psi[:, psi_dim_names.index(dim)])
        shape.append(len(unique_vals))
        dim_grid_values.append(unique_vals)

    if group_by:
        psi_group_vals = psi[:, [psi_dim_names.index(d) for d in group_by]]
        group_dim_values = np.unique(psi_group_vals, axis=0)
        num_groups = len(group_dim_values)
    else:
        num_groups = 1

    sort_thresholds = []
    for i, dim in enumerate(sort_by):
        grid_vals = sort_dim_grids[i]
        thresh = sort_dim_dist_thresh[i]
        dim_vals = psi[:, psi_dim_names.index(dim)]
        if grid_vals is None:
            if num_groups > 1:
                min_samples = max(num_groups - int(np.ceil(num_groups / 3)), 2)
                grid_vals, thresh = segment_dimension(dim_vals, min_samples=min_samples,
                                                      return_distance_thresh=True)
            else:
                grid_vals = np.unique(dim_vals)
                if thresh is None:
                    thresh = np.min(np.diff(grid_vals)) if len(grid_vals) > 1 else 1.0
        else:
            grid_vals = np.unique(grid_vals)
            if thresh is None:
                thresh = np.median(np.diff(grid_vals)) * 0.5 if len(grid_vals) > 1 else 1.0
        shape.append(len(grid_vals))
        dim_grid_values.append(grid_vals)
        sort_thresholds.append(thresh)

    if sort_by:
        sort_mesh = np.meshgrid(*dim_grid_values[len(group_by):][::-1])
        interp_points = np.vstack([m.flatten() for m in sort_mesh]).T
        for i in range(len(sort_by)):
            interp_points[:, i] /= sort_thresholds[i]
        if len(sort_by) == 1:
            interp_points = np.hstack([interp_points,
                                       np.ones((len(interp_points), 1))])
        psi_sort_vals = psi[:, [psi_dim_names.index(d) for d in sort_by]]

    def interp_group(meas_points_raw, meas_x):
        meas_points = np.atleast_2d(meas_points_raw).astype(float).copy()
        for j in range(len(sort_by)):
            meas_points[:, j] /= sort_thresholds[j]
        if len(sort_by) == 1:
            meas_points = np.hstack([meas_points, np.ones((len(meas_points), 1))])
        x_interp = resample(interp_points, meas_points, meas_x,
                            remove_invariant=False,
                            interp_class=interpolate.NearestNDInterpolator)
        if not impute:
            nn_dist = np.min(cdist(interp_points, meas_points), axis=1)
            x_interp[nn_dist > 1.0] = np.nan
        return x_interp.reshape([*sort_mesh[0].shape, x.shape[-1]])

    x_out = np.full((*shape, x.shape[-1]), np.nan)
    if num_groups > 1:
        for group_vals in group_dim_values:
            in_group = np.array([np.array_equal(pgv, group_vals)
                                 for pgv in psi_group_vals])
            out_idx = tuple(int(np.where(dim_grid_values[j] == val)[0][0])
                            for j, val in enumerate(group_vals))
            if sort_by:
                x_out[out_idx] = interp_group(psi_sort_vals[in_group], x[in_group])
            else:
                x_out[out_idx] = x[in_group]
    else:
        if sort_by:
            x_out = interp_group(psi_sort_vals, x)
        else:
            x_out = x
    return dim_grid_values, x_out


def flatten_groups(ndx, num_group_dims):
    new_shape = (*ndx.shape[:num_group_dims], int(np.prod(ndx.shape[num_group_dims:])))
    return ndx.reshape(new_shape)


def group_isnan(ndx, num_group_dims):
    return np.all(np.isnan(flatten_groups(ndx, num_group_dims)), axis=-1)


def group_nn_count(ndx, num_group_dims, axis=None):
    """Count fitted neighbors of each group along the given axes."""
    group_exists = ~group_isnan(ndx, num_group_dims)
    footprint = np.zeros((3,) * num_group_dims)
    axes = np.arange(num_group_dims) if axis is None else np.atleast_1d(axis)
    for ax in axes:
        ind1 = [1] * ax + [0] + [1] * (num_group_dims - 1 - ax)
        ind2 = list(ind1)
        ind2[ax] = 2
        footprint[tuple(ind1)] = 1
        footprint[tuple(ind2)] = 1
    return ndimage.convolve(group_exists.astype(float), footprint, mode="constant")


def filter_ndx(ndx, num_group_dims, impute=False, impute_groups=False, iterative=True,
               adaptive=False, mask_nans=True, filter_func=None, by_group=False,
               **filter_kw):
    """Group-aware N-D filtering with NaN handling (reference ndx.py:261-349)."""
    if impute_groups and by_group:
        raise ValueError("Group imputation cannot be performed when filtering by group")
    ndx = np.asarray(ndx, dtype=float)
    nan_obs_index = np.isnan(ndx)
    nan_group_index = group_isnan(ndx, num_group_dims)
    work = np.nan_to_num(ndx) if mask_nans else ndx

    if by_group:
        out = np.empty_like(work)
        for group_index in np.ndindex(*work.shape[:num_group_dims]):
            out[group_index] = _filter_ndx_sub(
                work[group_index], nan_obs_index[group_index], filter_func, filter_kw,
                mask_nans, iterative, adaptive)
    else:
        out = _filter_ndx_sub(work, nan_obs_index, filter_func, filter_kw, mask_nans,
                              iterative, adaptive)

    if impute:
        if not impute_groups:
            out[nan_group_index] = np.nan
    else:
        out[nan_obs_index] = np.nan
    return out


def _filter_ndx_sub(x_sub, nan_obs_index, filter_func, filter_kw, mask_nans, iterative,
                    adaptive):
    if filter_func is not None:
        if mask_nans:
            weights = (~nan_obs_index).astype(float)
            return masked_filter(x_sub, weights, filter_func=filter_func, **filter_kw)
        return filter_func(x_sub, **filter_kw)
    if iterative:
        nan_mask = nan_obs_index if mask_nans else None
        return iterative_gaussian_filter(x_sub, adaptive=adaptive, nan_mask=nan_mask,
                                         fill_nans=True, **filter_kw)
    weights = (~nan_obs_index).astype(float) if mask_nans else None
    if adaptive:
        sigmas = get_adaptive_sigmas(x_sub, weights=weights, **filter_kw)

        def func(a_in, **kw):
            return adaptive_gaussian_filter(a_in, sigmas=sigmas, **kw)
        if mask_nans:
            return masked_filter(x_sub, weights, filter_func=func, **filter_kw)
        return func(x_sub, **filter_kw)
    if mask_nans:
        return masked_filter(x_sub, weights, filter_func=ndimage.gaussian_filter,
                             **filter_kw)
    return ndimage.gaussian_filter(x_sub, **filter_kw)
