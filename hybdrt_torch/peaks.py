"""Peak weight decomposition of DRT distributions on the host (numpy).

Copy of the part of ``hybdrt_tpu/peaks.py`` that the map's ridge
integration reaches (``mapping/surface.py::integrate_ridges_1d``):
``estimate_peak_weight_distributions`` (:105) and the trough finder it calls
when no troughs are given, ``find_troughs`` (:75). The rest of that module
(peak finding, parameter estimation, peak matching) is not ported yet
(ROADMAP, Host modules).
"""
import numpy as np

from .utils.array import nearest_index


def find_troughs(f, fxx, peak_indices, peak_tau=None, tau=None):
    """Locate troughs between adjacent peaks (reference peaks.py:92-136)."""
    if peak_indices is None:
        if peak_tau is None or tau is None:
            raise ValueError("Provide peak_indices, or peak_tau with its tau grid")
        peak_indices = [nearest_index(np.log(tau), np.log(pt)) for pt in peak_tau]
    peak_indices = sorted(peak_indices)
    f_mix = -(f - fxx)
    trough_indices = []
    for i, start in enumerate(peak_indices[:-1]):
        end = peak_indices[i + 1]
        left_sign = np.sign(f[start])
        right_sign = np.sign(f[end])
        if left_sign == right_sign:
            sign = left_sign
            if np.min(sign * f[start:end]) < min(sign * f[start], sign * f[end]):
                trough = start + int(np.argmin(sign * f[start:end]))
            else:
                trough = start + int(np.argmax(sign * f_mix[start:end]))
                if trough in (start, end):
                    trough = int((start + end + 2 * trough) / 4)
        else:
            trough = start + nearest_index(f[start:end], 0)
        trough_indices.append(trough)
    return trough_indices


def estimate_peak_weight_distributions(tau, f, fxx, peak_indices, basis_tau,
                                       epsilon_factor=1.25, max_epsilon=1.25,
                                       min_epsilon=None, epsilon_uniform=None,
                                       trough_indices=None, peak_tau=None, trough_tau=None):
    """RBF-windowed split of coefficient weight among peaks; rows sum to 1
    over the basis grid (reference peaks.py:139-233)."""
    if peak_tau is None:
        peak_tau = tau[peak_indices]
    basis_tau = np.asarray(basis_tau)
    if len(peak_tau) == 0:
        # No peaks -> no weight rows (reference returns an empty set, not a
        # phantom all-ones peak)
        return np.zeros((0, len(basis_tau)))
    if len(peak_tau) == 1:
        return np.ones((1, len(basis_tau)))

    peak_tau = np.sort(np.asarray(peak_tau))
    rbf = lambda y, eps: np.exp(-(eps * np.asarray(y)) ** 2)

    if trough_tau is None:
        if trough_indices is None:
            trough_indices = find_troughs(f, fxx, peak_indices=None, peak_tau=peak_tau, tau=tau)
        trough_tau = tau[trough_indices]

    peak_weights = np.empty((len(peak_tau), len(basis_tau)))
    for i, tau_i in enumerate(peak_tau):
        if epsilon_uniform is None:
            prev_trough = tau[0] if i == 0 else trough_tau[i - 1]
            next_trough = tau[-1] if i == len(peak_tau) - 1 else trough_tau[i]
            l_eps = min(epsilon_factor / np.log(tau_i / prev_trough), max_epsilon)
            r_eps = min(epsilon_factor / np.log(next_trough / tau_i), max_epsilon)
            if min_epsilon is not None:
                l_eps = max(l_eps, min_epsilon)
                r_eps = max(r_eps, min_epsilon)
        else:
            l_eps = r_eps = epsilon_uniform
        left = basis_tau < tau_i
        peak_weights[i, left] = rbf(np.log(basis_tau[left] / tau_i), l_eps)
        peak_weights[i, ~left] = rbf(np.log(basis_tau[~left] / tau_i), r_eps)
    peak_weights /= np.sum(peak_weights, axis=0)
    return peak_weights
