"""Impedance and step-response integral lookup tables (counterpart of
``hybdrt_tpu/ops/lookup.py``).

Each impedance matrix element of a quadrature basis depends only on
log(w_n * tau_m), and each response matrix element only on
(t_n - t_step) / tau_m, so a 1-D table of the integral against that product
plus linear interpolation gives the whole matrix. Same grids and trapezoid rule
as the JAX package, in float64 numpy, for every quadrature basis (those
without a closed form: all but Cole-Cole, delta and zga).
"""
from functools import lru_cache

import numpy as np

from . import basis as basis_mod

IMPEDANCE_GRID_POINTS = 2000
RESPONSE_GRID_POINTS = 2000
QUAD_POINTS = 1000
Y_LIMIT = 20.0
# Lookup domain half-widths in log10(w*tau); imag integrand decays ~2x slower
RE_LIM = 2.7
IM_LIM = 2 * RE_LIM

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@lru_cache(maxsize=16)
def generate_impedance_lookup(basis_type, epsilon, grid_points=IMPEDANCE_GRID_POINTS,
                              zga_key=None):
    """Return ((log_wt_re, z_re), (log_wt_im, z_im)) lookup tables
    (hybdrt_tpu/ops/lookup.py:37-56). ``zga_key`` only keys the cache, as
    in the JAX package.

    Cached: callers must not modify the returned arrays."""
    wt_re_grid = np.logspace(-RE_LIM, RE_LIM, grid_points)
    wt_im_grid = np.logspace(-IM_LIM, IM_LIM, grid_points)
    y = np.linspace(-Y_LIMIT, Y_LIMIT, QUAD_POINTS)

    z_re_func = basis_mod.get_impedance_func("real", basis_type)
    z_im_func = basis_mod.get_impedance_func("imag", basis_type)
    z_re_grid = _trapezoid(z_re_func(y[None, :], wt_re_grid[:, None], 1.0, epsilon), x=y, axis=1)
    z_im_grid = _trapezoid(z_im_func(y[None, :], wt_im_grid[:, None], 1.0, epsilon), x=y, axis=1)
    return (np.log(wt_re_grid), z_re_grid), (np.log(wt_im_grid), z_im_grid)


@lru_cache(maxsize=16)
def generate_response_lookup(basis_type, op_mode, step_model, epsilon,
                             grid_points=RESPONSE_GRID_POINTS, tau_rise=None, zga_key=None):
    """(log_td_grid, response_grid): the unit-step response of a basis
    function at tau_m = 1 against log(t - t_step), over logspace(-6, 2)
    (hybdrt_tpu/ops/lookup.py:59-76); ``zga_key`` as above.

    Cached: callers must not modify the returned arrays."""
    td_grid = np.logspace(-6, 2, grid_points)
    y = np.linspace(-Y_LIMIT, Y_LIMIT, QUAD_POINTS)
    response_func = basis_mod.get_response_func(basis_type, op_mode, step_model)
    tau_rise_val = 0.0 if tau_rise is None else tau_rise
    response_grid = _trapezoid(
        response_func(y[None, :], 1.0, td_grid[:, None], epsilon, tau_rise_val), x=y, axis=1)
    return np.log(td_grid), response_grid
