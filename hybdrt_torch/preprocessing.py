"""Host-side data preprocessing (subset of ``hybdrt_tpu/preprocessing.py``):
step detection and step sizes (:17-70), the ideal-step input model
(:74-102), the Rp estimates (``estimate_rp`` :152, ``estimate_rp_batch``
:195), extreme-value flags (:262-271), the time since each step (:277) and
the basis-grid helpers (:292-337); and ``nearest_index`` ``unit_step`` and
``rel_round`` of ``hybdrt_tpu/utils/array.py:39``, ``:72``, ``:11``.

Non-ideal (``expdecay``) steps, whose step fit is a nonlinear least-squares
problem (``fit_signal_steps``, :117), and downsampling are not ported
(ROADMAP Queue 1 item 11).
"""
import numpy as np

from .utils.validation import check_step_model


def unit_step(x, x0=0.0):
    """Heaviside step: 1 where x >= x0, else 0."""
    return np.where(np.asarray(x) >= x0, 1.0, 0.0)


# ------------------------------------------------------------------
# Step detection
# ------------------------------------------------------------------
def identify_steps(y, allow_consecutive=True, rthresh=50, athresh=1e-10):
    """Indices where the input signal steps: |dy| at least rthresh times
    the median |dy| and at least athresh."""
    y = np.asarray(y)
    dy = np.diff(y)
    step_idx = np.where((np.abs(dy) >= np.median(np.abs(dy)) * rthresh)
                        & (np.abs(dy) >= athresh))[0] + 1
    if not allow_consecutive:
        idx_diff = np.concatenate(([2], np.diff(step_idx)))
        step_idx = step_idx[idx_diff > 1]
    return step_idx


def get_step_indices_from_step_times(times, step_times):
    """Index of the first sample at or after each step time."""
    times = np.asarray(times)
    out = []
    for st in step_times:
        delta = np.where(times >= st, times - st, np.inf)
        out.append(int(np.argmin(delta)))
    return np.array(out)


def get_step_sizes(times, y, step_times, step_index=None):
    """Each step's size: the mean of y after it (to the next step) less the
    mean over the previous step's interval."""
    if step_index is None:
        step_index = get_step_indices_from_step_times(times, step_times)
    n_steps = len(step_times)
    step_sizes = np.zeros(n_steps)
    for n in range(n_steps):
        end = len(y) if n == n_steps - 1 else step_index[n + 1]
        prev_start = 0 if n == 0 else step_index[n - 1]
        step_sizes[n] = np.mean(y[step_index[n]:end]) - np.mean(y[prev_start:step_index[n]])
    return step_sizes


def get_step_info(times, y, allow_consecutive=True, offset_step_times=False, offset_size=None,
                  rthresh=50, athresh=1e-10):
    """(step_times, step_sizes) of an input signal. With offset_step_times
    the step is placed (1 - 1e-8) of the shortest sample interval before the
    first changed sample, unless offset_size is given."""
    step_idx = identify_steps(y, allow_consecutive, rthresh, athresh)
    step_times = np.asarray(times)[step_idx].copy()
    if offset_step_times:
        if offset_size is None:
            t_sample = np.min(np.diff(times))
            offset_size = -t_sample * (1 - 1e-8)
        step_times = step_times + offset_size
    step_sizes = get_step_sizes(times, y, step_times, step_index=step_idx)
    return step_times, step_sizes


def process_input_signal(times, input_signal, step_model, offset_steps, offset_size=None,
                         rthresh=50):
    """(step_times, step_sizes, tau_rise) of the input signal; tau_rise is
    None for ideal steps, the only step model ported."""
    check_step_model(step_model)
    if step_model != "ideal":
        raise NotImplementedError(f"step_model={step_model!r}: non-ideal steps are not "
                                  f"ported yet (ROADMAP Queue 1 item 11)")
    step_times, step_sizes = get_step_info(times, input_signal, True, offset_steps,
                                           offset_size, rthresh)
    return step_times, step_sizes, None


def generate_model_signal(times, step_times, step_sizes, tau_rise, step_model):
    """The idealized input signal of the identified steps."""
    if step_model != "ideal":
        raise NotImplementedError(f"step_model={step_model!r}: non-ideal steps are not "
                                  f"ported yet (ROADMAP Queue 1 item 11)")
    times = np.asarray(times)
    signal = np.zeros(len(times))
    for st, sa in zip(step_times, step_sizes):
        signal += sa * unit_step(times, st)
    return signal


# ------------------------------------------------------------------
# Rp estimates
# ------------------------------------------------------------------
def _condense_steps(step_times, input_step_sizes):
    """Ideal steps closer than 2e-5 merged into one, their sizes summed."""
    new_step_index = np.concatenate(([0], np.where(np.diff(step_times) > 2e-5)[0] + 1))
    if len(new_step_index) < len(step_times):
        step_times_new = step_times[new_step_index]
        step_sizes_new = np.zeros_like(step_times_new)
        for i, start_index in enumerate(new_step_index):
            end_index = len(input_step_sizes) if i == len(new_step_index) - 1 \
                else new_step_index[i + 1]
            step_sizes_new[i] = np.sum(input_step_sizes[start_index:end_index])
        return step_times_new, step_sizes_new
    return step_times, input_step_sizes


def estimate_rp(times, step_times, input_step_sizes, response_signal, step_model, z):
    """Polarization resistance estimate from chrono and/or EIS data: the
    largest step response (99th percentile over steps) or Re(z) less the
    smallest (mean over steps) or Re(z)."""
    if times is not None:
        times = np.asarray(times)
        step_times = np.asarray(step_times, dtype=float)
        input_step_sizes = np.asarray(input_step_sizes, dtype=float)
        if step_model == "ideal":
            step_times, input_step_sizes = _condense_steps(step_times, input_step_sizes)
        step_index = get_step_indices_from_step_times(times, step_times)
        step_r_min = np.full(len(step_index), np.nan)
        step_r_max = np.full(len(step_index), np.nan)
        for i, start_index in enumerate(step_index):
            end_index = len(times) if i == len(step_index) - 1 else step_index[i + 1]
            if start_index == end_index:
                continue
            pre_step_val = response_signal[start_index - 1]
            step_response = response_signal[start_index:end_index]
            step_r_min[i] = np.min((step_response - pre_step_val) / input_step_sizes[i])
            step_r_max[i] = np.max((step_response - pre_step_val) / input_step_sizes[i])
        r_min_chrono = np.nanmean(step_r_min)
        r_max_chrono = np.nanpercentile(step_r_max, 99)
    else:
        r_min_chrono, r_max_chrono = np.inf, 0.0

    if z is not None:
        r_min_eis = np.min(np.asarray(z).real)
        r_max_eis = np.max(np.asarray(z).real)
    else:
        r_min_eis, r_max_eis = np.inf, 0.0

    return max(r_max_chrono, r_max_eis) - min(r_min_chrono, r_min_eis)


def estimate_rp_batch(times, step_times, input_step_sizes, response_batch, step_model,
                      z_batch):
    """``estimate_rp`` over a batch of observations that share one
    measurement protocol: ``response_batch`` (k, T) or None, ``z_batch``
    (k, F) or None -> (k,), row for row ``estimate_rp``'s values (the same
    reductions on the same values, stacked along the batch axis)."""
    if response_batch is not None:
        v = np.asarray(response_batch, dtype=float)
        k = v.shape[0]
        times = np.asarray(times)
        step_times = np.asarray(step_times, dtype=float)
        input_step_sizes = np.asarray(input_step_sizes, dtype=float)
        if step_model == "ideal":
            step_times, input_step_sizes = _condense_steps(step_times, input_step_sizes)
        step_index = get_step_indices_from_step_times(times, step_times)
        step_r_min = np.full((len(step_index), k), np.nan)
        step_r_max = np.full((len(step_index), k), np.nan)
        for i, start_index in enumerate(step_index):
            end_index = len(times) if i == len(step_index) - 1 else step_index[i + 1]
            if start_index == end_index:
                continue
            pre_step_val = v[:, start_index - 1]
            step_response = v[:, start_index:end_index]
            ratio = (step_response - pre_step_val[:, None]) / input_step_sizes[i]
            step_r_min[i] = np.min(ratio, axis=1)
            step_r_max[i] = np.max(ratio, axis=1)
        r_min_chrono = np.nanmean(step_r_min, axis=0)
        r_max_chrono = np.nanpercentile(step_r_max, 99, axis=0)
    else:
        k = np.asarray(z_batch).shape[0]
        r_min_chrono = np.full(k, np.inf)
        r_max_chrono = np.zeros(k)

    if z_batch is not None:
        zr = np.asarray(z_batch).real
        r_min_eis = np.min(zr, axis=1)
        r_max_eis = np.max(zr, axis=1)
    else:
        r_min_eis = np.full(k, np.inf)
        r_max_eis = np.zeros(k)

    return np.maximum(r_max_chrono, r_max_eis) - np.minimum(r_min_chrono, r_min_eis)


# ------------------------------------------------------------------
# Extreme values
# ------------------------------------------------------------------
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


# ------------------------------------------------------------------
# Basis grids
# ------------------------------------------------------------------
def get_time_since_step(times, step_times, prestep_value=None):
    """Each sample's time since the last step before it, at least the
    shortest sample interval; samples before the first step are dropped, or
    given prestep_value."""
    times = np.asarray(times)
    step_times = np.asarray(step_times, dtype=float)
    time_deltas = []
    t_sample = np.min(np.diff(times)) if len(times) > 1 else times[0]
    if prestep_value is not None:
        time_deltas.append(np.tile(prestep_value, len(times[times < step_times[0]])))
    for i, start_time in enumerate(step_times):
        end_time = np.inf if i == len(step_times) - 1 else step_times[i + 1]
        mask = (times >= start_time) & (times < end_time)
        if np.sum(mask) > 0:
            time_deltas.append(np.maximum(times[mask] - start_time, t_sample))
    return np.concatenate(time_deltas)


def get_tau_lim(frequencies, times=None, step_times=None):
    """(tau_min, tau_max) the data cover: 1 / (2 pi f) over the frequencies
    and the times since each step."""
    if frequencies is not None:
        frequencies = np.asarray(frequencies, dtype=float)
        eis_tau_min = 1 / (2 * np.pi * np.max(frequencies))
        eis_tau_max = 1 / (2 * np.pi * np.min(frequencies))
    else:
        eis_tau_min, eis_tau_max = np.inf, -np.inf
    if times is not None:
        td = get_time_since_step(times, step_times)
        chrono_tau_min, chrono_tau_max = np.min(td), np.max(td)
    else:
        chrono_tau_min, chrono_tau_max = np.inf, -np.inf
    return min(eis_tau_min, chrono_tau_min), max(eis_tau_max, chrono_tau_max)


def get_num_decades(frequencies, times=None, step_times=None):
    tau_min, tau_max = get_tau_lim(frequencies, times, step_times)
    return np.log10(tau_max) - np.log10(tau_min)


def rel_round(x, precision):
    """x rounded to ``precision`` significant digits of its largest entry."""
    x = np.asarray(x)
    x_max = np.max(np.abs(x)) if x.size else 0.0
    if x_max == 0:
        return x
    return np.round(x, precision - int(np.ceil(np.log10(x_max))))


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


def get_basis_tau(frequencies, times=None, step_times=None, ppd=10, extend_decades=1,
                  tau_grid=None):
    """10-ppd log grid covering the data range +- extend_decades, or, given
    ``tau_grid``, the slice of that supergrid that covers it."""
    tau_min, tau_max = get_tau_lim(frequencies, times, step_times)
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
