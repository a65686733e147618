"""Host-side data preprocessing (counterpart of ``hybdrt_tpu/preprocessing.py``):
step detection and step sizes (:17-70), the input signal's step models,
ideal and ``expdecay`` (:74-150; the non-ideal steps' nonlinear
least-squares fit with scipy's ``least_squares``, as in the JAX package),
the Rp estimates (``estimate_rp`` :152, ``estimate_rp_batch`` :195),
extreme-value flags (:262-271), the time since each step (:277), the
basis-grid helpers (:292-337) and the chrono downsampling family with its
antialiasing filter (:343-552, :603-622). ``nearest_index``, ``unit_step``
and ``rel_round`` come from ``utils/array.py``, as they do in the JAX
package.
"""
import numpy as np

from .utils.array import nearest_index, rel_round, unit_step  # noqa: F401 (pp.* names)
from .utils.validation import check_step_model


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
                         rthresh=50, fixed_tau_rise=None):
    """(step_times, step_sizes, tau_rise) of the input signal; tau_rise is
    None for ideal steps, and for ``expdecay`` steps each step's rise time
    from ``fit_signal_steps``, which also moves each step time by its fitted
    offset (:74-87)."""
    check_step_model(step_model)
    allow_consecutive = step_model == "ideal"
    step_times, step_sizes = get_step_info(times, input_signal, allow_consecutive,
                                           offset_steps, offset_size, rthresh)
    if step_model != "ideal":
        num_steps = len(step_times)
        fit = fit_signal_steps(times, input_signal, fixed_tau_rise=fixed_tau_rise)
        step_times = step_times + fit["x"][1:num_steps + 1] * 1e-6
        tau_rise = np.exp(fit["x"][num_steps + 1:])
    else:
        tau_rise = None
    return step_times, step_sizes, tau_rise


def generate_model_signal(times, step_times, step_sizes, tau_rise, step_model):
    """The input signal of the identified steps: ideal steps, or with
    ``expdecay`` each step rising as 1 - exp(-(t - t_step) / tau_rise)
    (:90-101)."""
    times = np.asarray(times)
    signal = np.zeros(len(times))
    if step_model == "ideal":
        for st, sa in zip(step_times, step_sizes):
            signal += sa * unit_step(times, st)
    else:
        for st, sa, tr in zip(step_times, step_sizes, tau_rise):
            mask = times >= st
            signal[mask] += sa * (1 - np.exp(-(times[mask] - st) / tr))
    return signal


def evaluate_step_fit(times, step_times, step_sizes, x):
    """The decaying-exponential step model of parameters x = (offset, the
    step-time offsets in microseconds, the log rise times) (:104-114)."""
    num_steps = len(step_times)
    signal_offset = x[0]
    t_step = step_times + x[1:num_steps + 1] * 1e-6
    tau_rise = np.exp(x[num_steps + 1:])
    y_hat = np.zeros(len(times)) + signal_offset
    for n in range(num_steps):
        mask = times >= t_step[n]
        y_hat[mask] += step_sizes[n] * (1 - np.exp(-(times[mask] - t_step[n]) / tau_rise[n]))
    return y_hat


def fit_signal_steps(times, signal, tau_var_penalty=0.1, t_step_offset_penalty=1e-5,
                     fixed_tau_rise=None):
    """Least-squares fit of non-ideal (``expdecay``) steps to the input
    signal (:117-149): the offset, each step time's offset and each log rise
    time, the rise times pulled toward their mean; with ``fixed_tau_rise``
    only the offsets are fitted. Returns {"x", "step_times", "step_sizes"}."""
    from scipy.optimize import least_squares
    step_times, step_sizes = get_step_info(times, signal, allow_consecutive=False)
    num_steps = len(step_times)

    fixed_tail = None if fixed_tau_rise is None \
        else np.full(num_steps, np.log(fixed_tau_rise))

    def resid(x):
        if fixed_tail is not None:
            x = np.concatenate([x, fixed_tail])
        r = evaluate_step_fit(times, step_times, step_sizes, x) - signal
        penalties = np.concatenate([
            t_step_offset_penalty * x[1:num_steps + 1],
            tau_var_penalty * (x[num_steps + 1:] - np.mean(x[num_steps + 1:])),
        ])
        return np.concatenate([r, penalties])

    x0 = np.zeros(1 + 2 * num_steps)
    x0[num_steps + 1:] = np.log(np.min(np.diff(times)))
    if fixed_tail is not None:
        result = least_squares(resid, x0[:num_steps + 1])
        x_out = np.concatenate([result.x, fixed_tail])
    else:
        result = least_squares(resid, x0)
        x_out = result.x
    return {"x": x_out, "step_times": step_times, "step_sizes": step_sizes}


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


# ------------------------------------------------------------------
# Chrono downsampling and its antialiasing filter (:343-552)
# ------------------------------------------------------------------
def generate_log_times(times, step_times, ppd, prestep_samples=None):
    """Target sample times, log-uniform after each step at ``ppd`` points a
    decade; before the first step every sample (None), ``prestep_samples``
    of them evenly, or none (0) (:343-365)."""
    times = np.asarray(times)
    step_times = np.asarray(step_times, dtype=float)
    t_sample = np.min(np.diff(times))
    out = []
    if prestep_samples is None or prestep_samples > 0:
        pre = times[times < step_times[0]]
        if prestep_samples is not None and len(pre) > prestep_samples:
            idx = np.unique(np.linspace(0, len(pre) - 1, prestep_samples).astype(int))
            pre = pre[idx]
        out.append(pre)
    for i, st in enumerate(step_times):
        end_time = times[-1] if i == len(step_times) - 1 else step_times[i + 1]
        span = end_time - st
        if span <= t_sample:
            continue
        num_decades = np.log10(span) - np.log10(t_sample)
        n_pts = max(2, int(np.ceil(num_decades * ppd)) + 1)
        out.append(st + np.logspace(np.log10(t_sample), np.log10(span), n_pts))
    return np.concatenate(out) if out else times


def _segment_sigmas(t_seg, t_sample, sigma_factor, max_sigma):
    """The filter's per-sample width on one segment between steps: the
    inverse curvature scale of an RC relaxation that starts one sample
    before the segment, e (t - t0) / 2, times ``sigma_factor``, in samples,
    capped at ``max_sigma``."""
    sigma_ideal = np.exp(1) * (t_seg - (t_seg[0] - t_sample)) / 2
    return np.minimum(sigma_factor * sigma_ideal / t_sample, max_sigma)


def filter_chrono_signal(times, y, step_index=None, input_signal=None, decimate_index=None,
                         sigma_factor=0.01, max_sigma=None, remove_outliers=False,
                         outlier_kw=None, median_prefilter=False, **kw):
    """The antialiasing filter (:368-422): a gaussian filter of per-sample
    width applied segment by segment between steps, the width growing with
    the time since the step (``_segment_sigmas``), capped where given by the
    widths of ``decimate_index``. ``remove_outliers`` first replaces the
    points ``flag_chrono_outliers`` flags by their filtered values."""
    from scipy.ndimage import median_filter
    from .filters import nonuniform_gaussian_filter1d
    times = np.asarray(times, dtype=float)
    y = np.asarray(y, dtype=float).copy()
    if step_index is None:
        if input_signal is not None:
            step_index = identify_steps(np.asarray(input_signal), allow_consecutive=False)
        else:
            step_index = identify_steps(y)

    if remove_outliers:
        y_filt = filter_chrono_signal(times, y, step_index=step_index,
                                      decimate_index=decimate_index, sigma_factor=sigma_factor,
                                      max_sigma=max_sigma, remove_outliers=False,
                                      median_prefilter=True, **kw)
        outlier_flag = flag_chrono_outliers(y, y_filt, **(outlier_kw or {}))
        y[outlier_flag] = y_filt[outlier_flag]

    t_sample = np.median(np.diff(times))
    if max_sigma is None:
        max_sigma = sigma_factor / t_sample
    dec_sigma = None
    if decimate_index is not None:
        dec_sigma = sigma_from_decimate_index(y, np.asarray(decimate_index))

    y_out = y.copy()
    for seg in np.split(np.arange(len(y)), step_index):
        if len(seg) < 5:
            continue
        sigmas = _segment_sigmas(times[seg], t_sample, sigma_factor, max_sigma)
        if dec_sigma is not None:
            sigmas = np.minimum(dec_sigma[seg], sigmas)
        seg_y = y[seg]
        if median_prefilter:
            seg_y = median_filter(seg_y, size=3, mode="nearest")
        y_out[seg] = nonuniform_gaussian_filter1d(seg_y, sigmas, **kw)
    return y_out


def filter_chrono_signal_batch(times, y_batch, step_index, sigma_factor=0.01):
    """``filter_chrono_signal`` over a (k, T) batch of responses of one
    protocol (the plain branch, :425-450): every row sees the same widths,
    so each row equals its own call's."""
    from .filters import nonuniform_gaussian_filter1d
    times = np.asarray(times, dtype=float)
    y = np.asarray(y_batch, dtype=float)
    t_sample = np.median(np.diff(times))
    max_sigma = sigma_factor / t_sample
    y_out = y.copy()
    for seg in np.split(np.arange(y.shape[1]), step_index):
        if len(seg) < 5:
            continue
        sigmas = _segment_sigmas(times[seg], t_sample, sigma_factor, max_sigma)
        y_out[:, seg] = nonuniform_gaussian_filter1d(
            y[:, seg], np.broadcast_to(sigmas, y[:, seg].shape), axis=-1)
    return y_out


def downsample_data(times, i_signal, v_signal, target_times=None, step_times=None,
                    op_mode="galv", ppd=20, prestep_samples=10, antialiased=True):
    """Log-uniform downsampling around the steps (:453-481): the first
    sample at or after each target time (``generate_log_times``), the
    response filtered first with ``antialiased``. Returns (sample_index,
    (times, i, v))."""
    times = np.asarray(times)
    i_signal = np.asarray(i_signal, dtype=float)
    v_signal = np.asarray(v_signal, dtype=float)
    if step_times is None:
        input_signal = i_signal if op_mode == "galv" else v_signal
        step_times = times[identify_steps(input_signal)]
    if target_times is None:
        target_times = generate_log_times(times, step_times, ppd, prestep_samples)
    sample_index = np.unique(np.searchsorted(times, target_times, side="left")
                             .clip(0, len(times) - 1))
    if antialiased:
        step_index = get_step_indices_from_step_times(times, step_times)
        response = v_signal if op_mode == "galv" else i_signal
        response_f = filter_chrono_signal(times, response, step_index=step_index)
        if op_mode == "galv":
            v_signal = response_f
        else:
            i_signal = response_f
    return sample_index, (times[sample_index], i_signal[sample_index], v_signal[sample_index])


def get_decimation_index(times, step_times, t_sample, prestep_points, decimation_interval,
                         decimation_factor, max_t_sample):
    """Geometric decimation after each step (:484-520): ``prestep_points``
    evenly spaced samples before the first step; after each step
    ``decimation_interval`` consecutive samples, then stretches of that many
    at strides decimation_factor**j, capped at max_t_sample / t_sample; the
    last sample before each next step kept."""
    times = np.asarray(times)
    step_times = np.atleast_1d(np.asarray(step_times))
    n_pre = np.sum(times < step_times.min())
    keep = [np.linspace(0, n_pre - 1, prestep_points).round().astype(int)] if n_pre else []
    max_stride = np.inf if max_t_sample is None else int(max_t_sample / t_sample)
    step_starts = [int(np.argmax((times >= st))) for st in step_times]
    boundaries = step_starts[1:] + [len(times)]
    for start, stop in zip(step_starts, boundaries):
        block = np.arange(start, min(start + decimation_interval + 1, stop))
        keep.append(block)
        last = block[-1]
        j = 1
        while last < stop - 1:
            stride = int(min(decimation_factor ** j, max_stride))
            end = stop if stride >= max_stride \
                else min(last + decimation_interval * stride + 1, stop)
            idx = np.arange(last + stride, end, stride)
            if len(idx) == 0:
                idx = np.array([end - 1])
            if end == stop and idx[-1] < stop - 1:
                idx = np.append(idx, stop - 1)
            keep.append(idx)
            last = idx[-1]
            j += 1
    return np.unique(np.concatenate(keep)).astype(int)


def select_decimation_interval(times, step_times, t_sample, prestep_points, decimation_factor,
                               max_t_sample, target_size):
    """The decimation interval whose sample count is nearest
    ``target_size`` (:523-536), interpolated over 12 log-spaced intervals
    from 2 to 1000; warns where the target is out of their range."""
    intervals = np.logspace(np.log10(2), np.log10(1000), 12).astype(int)
    sizes = [len(get_decimation_index(times, step_times, t_sample, prestep_points, iv,
                                      decimation_factor, max_t_sample)) for iv in intervals]
    if target_size > sizes[-1] or target_size < sizes[0]:
        import warnings
        warnings.warn(f"Cannot achieve target size {target_size} with decimation factor "
                      f"{decimation_factor}; adjust the factor or maximum period")
    return int(np.interp(target_size, sizes, intervals))


def sigma_from_decimate_index(y, decimate_index, truncate=4.0):
    """Filter widths for decimated sampling (:539-551): at each kept sample
    half the distance to its nearer kept neighbour over ``truncate``, 0
    where the sampling is dense; 0 elsewhere."""
    sigmas = np.zeros(len(y))
    diff = np.diff(decimate_index)
    ldiff = np.insert(diff, 0, diff[0])
    rdiff = np.append(diff, diff[-1])
    min_diff = np.minimum(ldiff, rdiff)
    sigma_dec = min_diff / (2 * truncate)
    sigma_dec[min_diff < 2] = 0
    sigmas[decimate_index] = sigma_dec
    return sigmas


def _pdf_normal(x, loc, scale):
    return 1 / (scale * np.sqrt(2 * np.pi)) * np.exp(-0.5 * (x - loc) ** 2 / scale ** 2)


def outlier_prob(x, mu_in, sigma_in, sigma_out, p_prior):
    """Bernoulli-prior outlier probability; deviations within sigma_in are
    never flagged (:603-612)."""
    sigma_out = np.maximum(np.asarray(sigma_out, dtype=float), 1e-300)
    pdf_in = _pdf_normal(x, mu_in, sigma_in)
    pdf_out = _pdf_normal(x, mu_in, sigma_out)
    p_out = np.array(p_prior * pdf_out / ((1 - p_prior) * pdf_in + p_prior * pdf_out))
    p_out[np.abs(np.asarray(x) - mu_in) <= sigma_in] = 0
    return p_out


def flag_chrono_outliers(y_raw, y_filt, thresh=0.75, p_prior=0.01):
    """Chrono points whose deviation from the filtered signal is an outlier
    with probability above ``thresh`` (:615-622)."""
    from .utils.stats import robust_std
    dev = np.asarray(y_filt) - np.asarray(y_raw)
    std = robust_std(dev)
    sigma_out = np.maximum(np.abs(dev), 0.01 * std)
    return outlier_prob(dev, 0, std, sigma_out, p_prior) > thresh
