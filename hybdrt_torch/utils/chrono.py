"""Chronopotentiometry time-axis helpers (copy of
``hybdrt_tpu/utils/chrono.py:12-58``, numpy only, kept here so that the port
runs where JAX is absent).

The forward transform maps each post-step interval onto a log scale, so that
the chrono variance-averaging matrix sees uniform effective spacing.
"""
import numpy as np

from .validation import check_ctrl_mode


def get_time_transforms(times, step_times):
    """(rev_transform, fwd_transform) between measurement time and a
    piecewise log-time coordinate, one segment per step."""
    times = np.asarray(times)
    start_times = np.asarray(step_times, dtype=float)

    t_sample = np.min(np.diff(times))
    trans_base = np.log(t_sample / 4)
    seg_offsets = np.log(start_times[1:] - start_times[:-1]) - trans_base
    trans_offsets = np.concatenate([[0.0], np.cumsum(seg_offsets)])

    def fwd_transform(t):
        t = np.atleast_1d(np.asarray(t, dtype=float))
        # segment of each time (-1: before the first step)
        seg = np.searchsorted(start_times, t, side="right") - 1
        tt = np.empty_like(t)
        pre = seg < 0
        tt[pre] = t[pre] - start_times[0]
        post = ~pre
        td = np.maximum(t[post] - start_times[seg[post]], t_sample / 2)
        tt[post] = trans_offsets[seg[post]] + np.log(td) - trans_base
        return tt

    def rev_transform(tt):
        tt = np.atleast_1d(np.asarray(tt, dtype=float))
        seg = np.searchsorted(trans_offsets, tt, side="right") - 1
        t = np.empty_like(tt)
        pre = seg < 0
        t[pre] = tt[pre] + start_times[0]
        post = ~pre
        t[post] = np.exp(tt[post] - trans_offsets[seg[post]] + trans_base) + start_times[seg[post]]
        return t

    return rev_transform, fwd_transform


def get_input_and_response(i_signal, v_signal, ctrl_mode):
    """(input, response) of the control mode: (i, v) galvanostatic, (v, i)
    potentiostatic."""
    if ctrl_mode is None:
        return None, None
    check_ctrl_mode(ctrl_mode)
    if ctrl_mode == "galv":
        return i_signal, v_signal
    return v_signal, i_signal
