"""Ridge/trough alternation consistency in N-D maps.

Copy of ``hybdrt_tpu/mapping/extrema.py:1-218`` (numpy/scipy):
``optimize_extrema_2d`` (:102) and the N-D ``optimize_extrema`` (:155).
Energy-descent optimizer matching the reference's extrema model
(reference hybdrt/mapping/extrema.py:27-221): each candidate flip of a
ridge/trough site is scored by (a) a log-odds probability term, (b) a
Gaussian attraction field toward existing extrema — both within the
(rows, tau) slab and, for N-D maps, across neighboring group slabs via a
NaN-masked normalized convolution over the full volume (reference
extrema.py:189-217) — and (c) an alternation repulsion term built from
per-window extremum counts (reference extrema.py:55-80). Each iteration
applies at most one flip per row (the lowest-energy move, if it lowers
energy); iteration stops when no move helps.

Host-side numpy/scipy (post-fit map analysis, not a hot path). The
window-count bookkeeping is vectorized over rows with a cumsum/bincount
segment trick instead of the reference's per-row Python loops.
"""
import numpy as np
from scipy import ndimage

from ..filters import masked_filter
from ..filters._filters import gaussian_kernel_scale


def _row_violations(ridge_row, trough_row):
    """Count adjacent same-type extrema (non-alternating) in one row."""
    events = []
    for idx in np.where(ridge_row)[0]:
        events.append((idx, 1))
    for idx in np.where(trough_row)[0]:
        events.append((idx, -1))
    events.sort()
    count = 0
    for (_, a), (_, b) in zip(events[:-1], events[1:]):
        if a == b:
            count += 1
    return count


def alternation_energy(ridge_mask, trough_mask):
    """Number of adjacent same-type extrema across all rows (diagnostic)."""
    return sum(_row_violations(r, t) for r, t in zip(ridge_mask, trough_mask))


def count_extrema(extrema_mask, bound_mask, bounded=True):
    """Per-site count of extrema inside windows delimited by the opposite
    extremum type, plus the window validity mask
    (reference extrema.py:27-52 count_extrema_row/count_extrema).

    A bound at column j opens a new window at j. ``bounded=True`` marks
    only sites lying between the first and last bound of the row as
    "windowed" (ridges must sit between troughs); ``bounded=False`` treats
    every site as windowed (row edges count as ridges, so troughs are
    always bounding).
    """
    em = np.asarray(extrema_mask, dtype=float)
    bm = np.asarray(bound_mask, dtype=bool)
    nrows, ncols = em.shape
    seg = np.cumsum(bm, axis=1)  # bound at j starts segment at j
    flat = (seg + np.arange(nrows)[:, None] * (ncols + 1)).ravel()
    totals = np.bincount(flat, weights=em.ravel(),
                         minlength=nrows * (ncols + 1))
    count = totals[flat].reshape(nrows, ncols)
    if bounded:
        has_two = bm.sum(axis=1) >= 2
        first = np.argmax(bm, axis=1)
        last = ncols - 1 - np.argmax(bm[:, ::-1], axis=1)
        cols = np.arange(ncols)
        window = ((cols >= first[:, None]) & (cols < last[:, None])
                  & has_two[:, None])
    else:
        window = np.ones((nrows, ncols), dtype=bool)
    return count, window


def _add_energy(count, window):
    """Energy of adding an extremum at each site (reference :55-66):
    crowded windows repel, empty bounded windows attract, out-of-window
    sites pay a small surcharge."""
    e = np.where(count > 0, count, 0.0)
    e = np.where((count == 0) & window, -1.0, e)
    return e + 0.5 * (~window)


def _remove_energy(count, window):
    """Energy of removing an extremum at each site (reference :69-80):
    removing the only windowed extremum costs, thinning a crowded window
    pays, out-of-window sites get a small removal bonus."""
    e = np.where((count == 1) & window, 1.0, 0.0)
    e = np.where(count > 1, -(count - 1.0), e)
    return e - 0.5 * (~window)


def _log_odds(prob, shape, lp_scale):
    if prob is None:
        return np.zeros(shape)
    p = np.nan_to_num(np.asarray(prob, dtype=float), nan=0.5)
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return lp_scale * np.log(p / (1 - p))


def optimize_extrema_2d(ridge_mask, trough_mask, ridge_prob=None,
                        trough_prob=None, max_energy_delta=0.0, max_iter=10,
                        attract_sigma=(5, 1), attraction=0.1, repulsion=10,
                        lp_scale=1, fixed_ridge_field=None,
                        fixed_trough_field=None):
    """Energy descent on one (rows, tau) slab
    (reference extrema.py:83-172). ``fixed_*_field`` carries the
    cross-slab attraction computed by :func:`optimize_extrema`.
    """
    rm = np.array(ridge_mask, dtype=bool)
    tm = np.array(trough_mask, dtype=bool)
    ridge_lp = _log_odds(ridge_prob, rm.shape, lp_scale)
    trough_lp = _log_odds(trough_prob, tm.shape, lp_scale)
    ks = np.prod([gaussian_kernel_scale(s) if s > 0 else 1.0
                  for s in attract_sigma])
    frf = 0.0 if fixed_ridge_field is None else np.asarray(fixed_ridge_field)
    ftf = 0.0 if fixed_trough_field is None else np.asarray(fixed_trough_field)
    rows = np.arange(rm.shape[0])

    for _ in range(max_iter):
        rcount, r_window = count_extrema(rm, tm, bounded=True)
        tcount, t_window = count_extrema(tm, rm, bounded=False)
        r_add = repulsion * _add_energy(rcount, r_window)
        r_rem = repulsion * _remove_energy(rcount, r_window)
        t_add = repulsion * _add_energy(tcount, t_window)
        t_rem = repulsion * _remove_energy(tcount, t_window)

        r_field = attraction * ks * ndimage.gaussian_filter(
            rm.astype(float), sigma=attract_sigma) + frf
        t_field = attraction * ks * ndimage.gaussian_filter(
            tm.astype(float), sigma=attract_sigma) + ftf

        # Site energy: occupying a site costs -(log-odds + attraction).
        r_site = -(ridge_lp + r_field)
        t_site = -(trough_lp + t_field)
        # Energy change of flipping each site: off->on pays the site energy
        # plus the add repulsion; on->off recovers it plus the remove term.
        r_delta = np.where(rm, -r_site + r_rem, r_site + r_add)
        t_delta = np.where(tm, -t_site + t_rem, t_site + t_add)

        r_idx = np.argmin(r_delta, axis=1)
        t_idx = np.argmin(t_delta, axis=1)
        r_best = r_delta[rows, r_idx]
        t_best = t_delta[rows, t_idx]
        flip_r = (r_best <= t_best) & (r_best < max_energy_delta)
        flip_t = (t_best < r_best) & (t_best < max_energy_delta)
        if not (flip_r.any() or flip_t.any()):
            break
        rm[rows[flip_r], r_idx[flip_r]] ^= True
        tm[rows[flip_t], t_idx[flip_t]] ^= True
    return rm, tm


def optimize_extrema(ridge_mask, trough_mask, ridge_prob=None,
                     trough_prob=None, attract_sigma=None,
                     max_energy_delta=0.0, max_iter=10, attraction=1.0,
                     repulsion=100.0, lp_scale=1.0, num_loops=1):
    """N-D entry point over masks of shape (*group_dims, rows, tau)
    (reference extrema.py:175-221).

    Each slab is repaired by :func:`optimize_extrema_2d` under a fixed
    cross-slab attraction field: the full N-D ridge/trough masks, with the
    current slab excluded (NaN-masked), are blurred by a normalized
    Gaussian convolution with per-axis ``attract_sigma`` (default
    ``(1,)*n_group + (5, 1)``), so a slab missing an extremum is pulled
    toward its neighbors' extremum positions.
    """
    rm = np.array(ridge_mask, dtype=bool)
    tm = np.array(trough_mask, dtype=bool)
    if rm.ndim <= 2:
        return optimize_extrema_2d(
            rm, tm, ridge_prob, trough_prob,
            max_energy_delta=max_energy_delta, max_iter=max_iter,
            attract_sigma=(5, 1) if attract_sigma is None else attract_sigma,
            attraction=attraction, repulsion=repulsion, lp_scale=lp_scale)

    n_group = rm.ndim - 2
    if attract_sigma is None:
        attract_sigma = (1,) * n_group + (5, 1)
    ks = np.prod([gaussian_kernel_scale(s) if s > 0 else 1.0
                  for s in attract_sigma])
    rp = None if ridge_prob is None else np.asarray(ridge_prob, dtype=float)
    tp = None if trough_prob is None else np.asarray(trough_prob, dtype=float)

    for _ in range(num_loops):
        for idx in np.ndindex(*rm.shape[:n_group]):
            if rp is not None and np.all(np.isnan(rp[idx])):
                continue
            # Cross-slab attraction: blur the masks over the whole volume
            # with the current slab (and NaN-prob sites) excluded, so the
            # field at this slab reflects only its neighbors.
            rm_f = rm.astype(float)
            rm_f[idx] = np.nan
            tm_f = tm.astype(float)
            tm_f[idx] = np.nan
            valid = ~np.isnan(rm_f)
            if rp is not None:
                valid &= ~np.isnan(rp)
            r_field = masked_filter(np.nan_to_num(rm_f), valid,
                                    filter_func=ndimage.gaussian_filter,
                                    sigma=attract_sigma)
            t_field = masked_filter(np.nan_to_num(tm_f), valid,
                                    filter_func=ndimage.gaussian_filter,
                                    sigma=attract_sigma)
            r_field = np.nan_to_num(r_field) * attraction * ks
            t_field = np.nan_to_num(t_field) * attraction * ks
            rm[idx], tm[idx] = optimize_extrema_2d(
                rm[idx], tm[idx],
                None if rp is None else rp[idx],
                None if tp is None else tp[idx],
                max_energy_delta=max_energy_delta, max_iter=max_iter,
                attract_sigma=attract_sigma[n_group:],
                attraction=attraction, repulsion=repulsion,
                lp_scale=lp_scale,
                fixed_ridge_field=r_field[idx],
                fixed_trough_field=t_field[idx])
    return rm, tm
