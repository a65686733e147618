"""Filters of the post-fit map pipeline (copy of ``hybdrt_tpu/filters/__init__.py``,
the same exports; ``curvreg``, the JAX package's jitted curvature
regularization, is not ported yet: ROADMAP Queue 1 item 9)."""
from ._filters import (rms_filter, std_filter, iqr_filter, rog_filter, masked_filter,
                       nan_filter, iterative_gaussian_filter, iterate_gaussian_weights,
                       nonuniform_gaussian_filter1d, nonuniform_gaussian_filter,
                       get_adaptive_sigma1d, get_adaptive_sigmas,
                       adaptive_gaussian_filter1d, adaptive_gaussian_filter,
                       signed_hysteresis_threshold, flexible_hysteresis_threshold,
                       apply_filter)
from ._scifilters import (empty_gaussian_filter1d, empty_gaussian_filter,
                          gaussian_laplace1d)

__all__ = [
    "rms_filter", "std_filter", "iqr_filter", "rog_filter", "masked_filter",
    "nan_filter", "iterative_gaussian_filter", "iterate_gaussian_weights",
    "nonuniform_gaussian_filter1d", "nonuniform_gaussian_filter",
    "get_adaptive_sigma1d", "get_adaptive_sigmas", "adaptive_gaussian_filter1d",
    "adaptive_gaussian_filter", "signed_hysteresis_threshold",
    "flexible_hysteresis_threshold", "apply_filter", "empty_gaussian_filter1d",
    "empty_gaussian_filter", "gaussian_laplace1d",
]
