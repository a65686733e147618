"""Precision-aware array utilities on the host (numpy).

Copy of ``hybdrt_tpu/utils/array.py:1-193`` (``rel_round`` :11 ...
``inctrapz`` :188), kept here so that the port runs where JAX is absent: every
module of the JAX package imports JAX through its package's ``__init__``.
They drive grid construction and the map's post-fit analysis, not device
compute.
"""
import numpy as np


def rel_round(x, precision):
    """Round to a relative precision of ``precision`` significant digits."""
    x = np.asarray(x)
    # Digits to the left of the decimal point
    x_max = np.max(np.abs(x)) if x.size else 0.0
    if x_max == 0:
        return x
    num_digits = int(np.ceil(np.log10(x_max)))
    return np.round(x, precision - num_digits)


def is_uniform(x, tol_digits=10):
    """True if x is uniformly spaced."""
    x = np.asarray(x)
    if len(x) < 2:
        return False
    xdiff = np.diff(x)
    return bool(np.all(rel_round(xdiff, tol_digits) == rel_round(xdiff[0], tol_digits)))


def is_log_uniform(x, tol_digits=10):
    """True if x is uniformly spaced in log space."""
    x = np.asarray(x)
    if len(x) < 2 or np.any(x <= 0):
        return False
    return is_uniform(np.log(x), tol_digits)


def nearest_index(x_array, x_val, constraint=None):
    """Index of the entry of ``x_array`` nearest to ``x_val``.

    :param constraint: if -1, require x_array[idx] <= x_val; if 1, require >=.
    """
    x_array = np.asarray(x_array, dtype=float)
    if constraint is None:
        return int(np.argmin(np.abs(x_array - x_val)))
    elif constraint in (-1, 1):
        delta = (x_array - x_val) * constraint
        delta[delta < 0] = np.inf
        if np.all(np.isinf(delta)):
            # No entry satisfies the constraint; fall back to nearest
            return int(np.argmin(np.abs(x_array - x_val)))
        return int(np.argmin(delta))
    else:
        raise ValueError(f"Invalid constraint {constraint}; options: None, -1, 1")


def is_subset(x, y, precision=10):
    """True if x is a contiguous subset of y (to relative precision)."""
    x = rel_round(np.asarray(x), precision)
    y = rel_round(np.asarray(y), precision)
    return bool(np.all(np.isin(x, y)))


def get_subset_index(x, y, precision=10):
    """Indices of entries of y matching entries of x."""
    x = rel_round(np.asarray(x), precision)
    y = rel_round(np.asarray(y), precision)
    return np.where(np.isin(y, x))[0]


def unit_step(x, x0=0.0):
    """Heaviside step: 1 where x >= x0, else 0."""
    x = np.asarray(x)
    return np.where(x >= x0, 1.0, 0.0)


def group_values(x, precision=10):
    """Group close values of x, returning sorted unique representative values."""
    xr = rel_round(np.asarray(x), precision)
    return np.unique(xr)


def find_contiguous_ranges(index):
    """Split a sorted integer index array into contiguous [start, end) ranges.

    Returns (range_starts, range_ends) such that index is the union of
    arange(start, end) over the pairs (reference utils/array.py usage in
    models/pfrt.py:22-31)."""
    index = np.asarray(index)
    if len(index) == 0:
        return np.array([], dtype=int), np.array([], dtype=int)
    breaks = np.where(np.diff(index) > 1)[0]
    range_starts = np.concatenate([[index[0]], index[breaks + 1]])
    range_ends = np.concatenate([index[breaks], [index[-1]]]) + 1
    return range_starts, range_ends


def is_monotonic_ascending(x):
    return bool(np.all(np.diff(np.asarray(x)) > 0))


def is_monotonic(x):
    d = np.diff(np.asarray(x))
    return bool(np.all(d > 0) or np.all(d < 0))


def apply_unit_step(x, x0, y_left=0.0, y_right=1.0):
    """Heaviside-style step at x0."""
    return np.where(np.asarray(x) >= x0, y_right, y_left)


def check_equality(a, b):
    """Robust equality for arrays/None pairs (reference utils/array.py)."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def find_contiguous_centers(index):
    """Center position of each contiguous run of indices."""
    starts, ends = find_contiguous_ranges(np.asarray(index))
    return np.array([(s + e - 1) / 2 for s, e in zip(starts, ends)])


def get_intersection_index(a, b):
    """Indices in a of values also present in b (order of a preserved)."""
    mask = np.isin(np.asarray(a), np.asarray(b))
    return np.where(mask)[0]


def weighted_quantile_2d(values, quantiles, sample_weight=None, axis=0):
    """Weighted quantiles of a 2-D array along `axis` (reference
    utils/array.py; quantiles in [0, 1])."""
    values = np.asarray(values, dtype=float)
    quantiles = np.atleast_1d(np.asarray(quantiles, dtype=float))
    if np.any((quantiles < 0) | (quantiles > 1)):
        raise ValueError("quantiles must be in [0, 1]")
    if axis == 1:
        values = values.T
    n = values.shape[0]
    w = np.ones(n) if sample_weight is None else np.asarray(sample_weight,
                                                            dtype=float)
    order = np.argsort(values, axis=0)
    v_sorted = np.take_along_axis(values, order, axis=0)
    w_sorted = w[order]
    cw = np.cumsum(w_sorted, axis=0)
    cw = (cw - 0.5 * w_sorted) / cw[-1]
    out = np.empty((len(quantiles), values.shape[1]))
    for j in range(values.shape[1]):
        out[:, j] = np.interp(quantiles, cw[:, j], v_sorted[:, j])
    return out


def row_match_index(a, b, precision=None):
    """For each row of b, the index of the matching row in a (-1 if none);
    a must have unique rows (reference utils/array.py)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if precision is not None:
        a, b = rel_round(a, precision), rel_round(b, precision)
    match = np.all(a[:, None, :] == b[None, :, :], axis=2)
    a_idx, b_idx = np.nonzero(match)
    out = np.full(len(b), -1, dtype=int)
    out[b_idx] = a_idx
    return out


def apply_along_axis_multi(func1d, axis, arrays, *args, **kwargs):
    """np.apply_along_axis generalized to multiple same-shape inputs:
    func1d receives a list of 1-D slices (reference utils/array.py)."""
    arrays = [np.asanyarray(a) for a in arrays]
    axis = axis % arrays[0].ndim  # normalize negative axes before stacking
    stacked = np.stack(arrays, axis=0)
    moved = np.moveaxis(stacked, axis + 1, -1)  # (n_arrays, ..., L)
    lead_shape = moved.shape[1:-1]
    results = {idx: np.asarray(func1d([moved[(k, *idx)]
                                       for k in range(len(arrays))],
                                      *args, **kwargs))
               for idx in np.ndindex(*lead_shape)}
    first = next(iter(results.values()))
    out = np.empty(lead_shape + first.shape, dtype=first.dtype)
    for idx, val in results.items():
        out[idx] = val
    return np.moveaxis(out, len(lead_shape), axis) if first.ndim else out


def inctrapz(y, x=None, axis=-1, initial=0.0):
    """Cumulative (incremental) trapezoidal integral
    (reference utils/array.py)."""
    from scipy.integrate import cumulative_trapezoid
    return cumulative_trapezoid(y, x=x, axis=axis, initial=initial)
