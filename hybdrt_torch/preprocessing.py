"""Basis-grid and data helpers (subset of ``hybdrt_tpu/preprocessing.py``:
``estimate_rp`` :152, ``identify_extreme_values`` :262-271, the grid helpers
:292-337; and ``nearest_index`` of ``hybdrt_tpu/utils/array.py:39``).

EIS only: the chrono branches of the JAX module (steps, time since step)
belong to the hybrid port.
"""
import numpy as np


def estimate_rp(z):
    """Polarization resistance estimate of an EIS spectrum: the range of
    Re(z), taken against 0 and inf as the JAX function takes it when no
    chrono data are given (hybdrt_tpu/preprocessing.py:152)."""
    zr = np.asarray(z).real
    return max(0.0, np.max(zr)) - min(np.inf, np.min(zr))


def get_quantile_limits(y, qr_size=0.5, qr_thresh=1.5):
    q_lo = np.percentile(y, 50 - 100 * qr_size / 2)
    q_hi = np.percentile(y, 50 + 100 * qr_size / 2)
    qr = q_hi - q_lo
    return q_lo - qr * qr_thresh, q_hi + qr * qr_thresh


def identify_extreme_values(y, qr_size=0.5, qr_thresh=1.5):
    """True where y lies more than qr_thresh inter-quantile ranges (of the
    central qr_size of y) outside that range."""
    y_min, y_max = get_quantile_limits(y, qr_size, qr_thresh)
    return (y < y_min) | (y > y_max)


def get_tau_lim(frequencies):
    frequencies = np.asarray(frequencies, dtype=float)
    return 1 / (2 * np.pi * np.max(frequencies)), 1 / (2 * np.pi * np.min(frequencies))


def nearest_index(x_array, x_val, constraint=None):
    """Index of the entry of ``x_array`` nearest to ``x_val``; with
    constraint -1 the entry must be <= x_val, with 1 >= x_val (the nearest
    entry when none is)."""
    x_array = np.asarray(x_array, dtype=float)
    if constraint is None:
        return int(np.argmin(np.abs(x_array - x_val)))
    if constraint not in (-1, 1):
        raise ValueError(f"Invalid constraint {constraint}; options: None, -1, 1")
    delta = (x_array - x_val) * constraint
    delta[delta < 0] = np.inf
    if np.all(np.isinf(delta)):
        return int(np.argmin(np.abs(x_array - x_val)))
    return int(np.argmin(delta))


def get_basis_tau(frequencies, ppd=10, extend_decades=1, tau_grid=None):
    """10-ppd log grid covering the data range +- extend_decades, or, given
    ``tau_grid``, the slice of that supergrid that covers it
    (hybdrt_tpu/preprocessing.py:311)."""
    tau_min, tau_max = get_tau_lim(frequencies)
    log_tau_min = np.log10(tau_min) - extend_decades
    log_tau_max = np.log10(tau_max) + extend_decades

    if tau_grid is not None:
        tau_grid = np.asarray(tau_grid)
        if 10 ** log_tau_min < np.min(tau_grid):
            left_index = 0
        else:
            left_index = nearest_index(tau_grid, 10 ** log_tau_min, constraint=-1)
        if 10 ** log_tau_max > np.max(tau_grid):
            right_index = len(tau_grid)
        else:
            right_index = nearest_index(tau_grid, 10 ** log_tau_max, constraint=1) + 1
        return tau_grid[left_index:right_index]
    num_points_exact = (log_tau_max - log_tau_min) * ppd + 1
    num_points = int(np.ceil(num_points_exact))
    add_decades = 0.5 * (num_points - num_points_exact) / ppd
    return np.logspace(log_tau_min - add_decades, log_tau_max + add_decades, num_points)


def get_epsilon_from_ppd(ppd, factor=1):
    return factor / np.log(10 ** (1 / ppd))
