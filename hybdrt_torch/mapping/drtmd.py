"""DRTMD: a map of DRT fits over operating-condition coordinates psi, and
the group resolve (counterpart of ``hybdrt_tpu/mapping/drtmd.py``).

``DRTMD`` stores observations (EIS spectra, chrono records or both) at
coordinates psi on a shared tau supergrid and fits them one by one with the
map's ``DRT`` (``fit_all()``, the reference's serial loop, each fit's state
and distribution variance stored) or all together with
``fit_all(batched=True)`` (a uniform EIS grid through one
``BatchedEISFitter``, a uniform hybrid protocol through one
``BatchedHybridFitter``, everything else through the ``BatchedRaggedFitter``).
It rebuilds each batched fit's posterior (P, q) on the device
(``get_fits_batched``) and re-optimizes a group jointly (``resolve_group``):
the observations are sorted by psi and either the whole group is solved as
one coupled QP (``coupled=True``) or overlapping windows of ``batch_size``
are solved, together (``batched=True``) or one dense QP after another (the
default, ``resolve_observations``), and averaged over their overlaps. A
fitted map is read on the host (predictions, filters, QC scores,
persistence: ``hybdrt_tpu/mapping/drtmd.py:1590-2069``); its covariance
readouts invert the fits' P in float64 on the map's device.

The free function ``resolve_group(fitter, result, z_batch, ...)`` is the
uniform-group body of ``DRTMD.resolve_group`` for a map fitted by one
``BatchedEISFitter``, without the class.
"""
import pickle
import time
import warnings
from copy import deepcopy
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
from scipy import ndimage
from scipy.special import gammaln, ndtr

from .. import preprocessing as pp
from ..models.drt import (DRT, data_offset_parameters, default_basis_nu, default_nu_epsilon,
                          special_slice)
from ..ops import basis as basis_mod
from ..ops import mat1d, phasance
from ..parallel.batch import BatchedEISFitter, BatchedHybridFitter
from ..parallel.ragged import BatchedRaggedFitter
from ..solver.qphb import QPHBConfig
from ..utils.device import resolve_device
from . import nddata, surface
from . import resolve as resolve_mod


class GroupResolveResult(NamedTuple):
    """Resolved parameters in the order of the fit's batch."""
    x: np.ndarray         # (nr, right - left) DRT coefficients on the supergrid window
    special: dict         # name -> (nr,): R_inf, inductance
    tau_indices: tuple    # (left, right) of the window on the fitter's tau_supergrid
    order: np.ndarray     # (nr,) the psi order the observations were resolved in
    info: dict            # resolve_info, and the solver's counts


def uniform_pq(fitter, result, z_batch):
    """Each observation's posterior (P, q) at its final fit state: the
    weighted QP of the last outer iteration, rebuilt in float64 on the
    fitter's device from ``result`` (rho, s_vectors, weights, scale; device
    tensors with ``collect="lazy"``) and the spectra (drtmd.py:1036). Returns
    host float64 (B, N, N), (B, N)."""
    p, q, _ = fitter._posterior(result, z_batch)
    return p.cpu().numpy(), q.cpu().numpy()


def psi_order(psi):
    """Sort order of the observations by psi, the first column the primary
    key (drtmd.py:1431-1435); psi (nr,) or (nr, n_dims)."""
    psi = np.asarray(psi, dtype=float)
    cols = psi[:, None] if psi.ndim == 1 else psi
    return np.lexsort(cols.T[::-1])


def resolve_windows(num_obs, batch_size, overlap):
    """(start, end) of each overlapping window (drtmd.py:1483-1493)."""
    batch_size = min(batch_size, num_obs)
    step = max(batch_size - overlap, 1)
    windows = []
    for start in range(0, num_obs, step):
        if num_obs - start < batch_size:
            start = max(0, num_obs - batch_size)
        windows.append((start, start + batch_size))
        if start + batch_size >= num_obs:
            break
    return windows


def group_objective(fitter, result, z_batch, psi, out):
    """The coupled group objective 1/2 x.Hx + q.x (host float64, solver
    units) of the psi-sorted group at the resolved solution ``out`` of
    ``resolve_group`` (default assembly options), as
    tests/test_resolve_coupled.py:135 evaluates it: the coupled resolve
    minimizes it, so it is no higher there than at the windowed resolve."""
    p_all, q_all = uniform_pq(fitter, result, z_batch)
    order = psi_order(psi)
    scale = np.asarray(result.scale, dtype=float)[order]
    r_inf_scaled = (np.asarray(result.r_inf, dtype=float) / np.asarray(result.scale))[order]
    xds = _x_dop_scaled(fitter, result)
    p, q, _, my, cmat, (special, _, _, _) = resolve_mod.prepare_group_blocks(
        p_all[order], q_all[order], scale, r_inf_scaled, [fitter.tau_indices] * len(order),
        fitter.special_qp_params, True, x_dop_scaled=None if xds is None else xds[order])
    ns = sum(info.get("size", 1) for info in special.values())
    x = np.zeros(q.shape)
    x[:, ns:] = out.x[order] / scale[:, None]
    units = {"inductance": fitter.inductance_scale, "C_inv": fitter.capacitance_scale,
             "x_dop": fitter.dop_scale_vector}
    for key, info in special.items():
        unit = units.get(key)
        unit = 1.0 if unit is None else unit
        cols = slice(info["index"], info["index"] + info.get("size", 1))
        x[:, cols] = np.reshape(out.special[key][order], (len(order), -1)) \
            / (scale[:, None] * unit)
    return block_objective(p, q, my, cmat, x)


def _x_dop_scaled(fitter, result):
    """Each lane's x_dop / (its scale times the DOP scale vector), the
    values the DOP block's psi penalty reads (resolve.py:169-172); None
    without a DOP."""
    if result.x_dop is None:
        return None
    return np.asarray(result.x_dop) / (np.asarray(result.scale, dtype=float)[:, None]
                                       * fitter.dop_scale_vector)


def block_objective(p, q, my, cmat, x):
    """1/2 x.Hx + q.x of the group blocks of ``prepare_group_blocks`` at x
    (nr, nc), H = blockdiag(P_i) + My (x) Cmat (host float64)."""
    hx = np.einsum("bij,bj->bi", p, x) + (my @ x) @ cmat
    return float(0.5 * np.vdot(x, hx) + np.vdot(q, x))


def solve_dense_windows(systems, dtype=None, device=None):
    """Each window's blocks (``prepare_group_blocks``' first five outputs)
    solved as one dense QP after another, the reference's default resolve
    (``hybdrt_tpu/mapping/drtmd.py:1560-1585``). Returns ([x (w, nc)], info)
    with the windows' IP iterations in ``info["n_iter"]``."""
    xs, n_iter = [], []
    for p_stack, q_stack, lb, my, cmat in systems:
        x, it = resolve_mod.solve_dense_window(*resolve_mod.dense_system(
            p_stack, q_stack, lb, my, cmat), dtype=dtype, device=device)
        xs.append(x.reshape(np.shape(q_stack)))
        n_iter.append(it)
    return xs, {"dense": True, "n_iter": np.array(n_iter)}


def resolve_group(fitter, result, z_batch, psi=None, coupled=False, batched=True,
                  batch_size=7, overlap=2, sigma=1, lambda_psi=1, tau_filter_sigma=0,
                  dtype=None, device=None):
    """Jointly re-optimize the spectra ``z_batch`` (B, n_freq) that ``fitter``
    (built with a ``tau_supergrid``) fitted into ``result``.

    ``psi`` (B,) or (B, n_dims) orders the observations (first column
    first); without it they keep the batch's order. ``coupled=True`` solves
    the whole group as one QP (``resolve.solve_coupled_group``) and reports
    its KKT residual against a tolerance, with a warning above it;
    otherwise the windows of ``batch_size`` overlapping by ``overlap`` are
    solved together (``batched=True``, ``resolve.solve_resolve_batch``) or
    one dense QP after another (``batched=False``, the reference's form,
    ``resolve.solve_dense_window``) and averaged with the reference's margin
    weights. ``dtype`` (default float64) is the solve's; the solve runs on
    the CUDA card unless ``device="cpu"``.
    """
    if fitter.tau_indices is None:
        raise ValueError("the fitter has no tau_supergrid: build it with "
                         "BatchedEISFitter(..., tau_supergrid=...)")
    x_fit = np.asarray(result.x)
    if not (np.all(np.isfinite(x_fit)) and np.all(np.isfinite(result.r_inf))):
        bad = np.flatnonzero(~(np.isfinite(x_fit).all(axis=1) & np.isfinite(result.r_inf)))
        raise ValueError(f"Batched fit produced non-finite coefficients at {bad.tolist()}")
    num_obs = len(x_fit)
    order = np.arange(num_obs) if psi is None else psi_order(psi)

    p_all, q_all = uniform_pq(fitter, result, z_batch)
    scale = np.asarray(result.scale, dtype=float)
    r_inf_scaled = np.asarray(result.r_inf, dtype=float) / scale
    tau_indices = tuple(fitter.tau_indices)
    nonneg = bool(np.all(np.asarray(fitter.lb.cpu())[fitter.num_special:] >= 0))
    xds = _x_dop_scaled(fitter, result)

    def blocks(idx):
        return resolve_mod.prepare_group_blocks(
            p_all[idx], q_all[idx], scale[idx], r_inf_scaled[idx], [tau_indices] * len(idx),
            fitter.special_qp_params, nonneg, sigma=sigma, lambda_psi=lambda_psi,
            tau_filter_sigma=tau_filter_sigma, x_dop_scaled=None if xds is None else xds[idx])

    def unpack(x, idx, special_dict):
        return resolve_mod.unpack_resolved_x(x, scale[idx], special_dict,
                                             fitter.inductance_scale,
                                             dop_scale_vector=fitter.dop_scale_vector,
                                             capacitance_scale=fitter.capacitance_scale)

    solve_kw = dict(dtype=dtype, device=device, return_info=True)
    if coupled and num_obs > 1:
        p_stack, q_stack, lb, my, cmat, (special_dict, _, _, _) = blocks(order)
        x, n_iter, kkt, counts = resolve_mod.solve_coupled_group(p_stack, q_stack, lb, my,
                                                                 cmat, **solve_kw)
        # Calibrated in the JAX package: relative KKT ~1e-14 (f64) / ~1e-5
        # (f32) on representative systems, so 2+ orders of headroom
        kkt_scale = max(1.0, float(np.abs(q_stack).max()))
        kkt_tol = (1e-3 if dtype == torch.float32 else 1e-6) * kkt_scale
        info = {"coupled": True, "n_iter": n_iter, "kkt_residual": kkt, "kkt_tol": kkt_tol,
                **counts}
        if not np.isfinite(kkt) or kkt > kkt_tol:
            warnings.warn(
                f"Coupled group resolve did not fully converge (KKT residual {kkt:.3g} > "
                f"{kkt_tol:.3g} after {n_iter} IP iterations); the resolved distributions "
                f"may be inaccurate. Consider dtype=float64 or the windowed resolve "
                f"(coupled=False).")
        x_drt, x_sp = unpack(x, order, special_dict)
        x_out = np.zeros_like(x_drt)
        x_out[order] = x_drt
        special = {}
        for key, val in x_sp.items():
            special[key] = np.zeros_like(val)
            special[key][order] = val
        return GroupResolveResult(x_out, special, tau_indices, order, info)

    # Windowed: every window's block QP solved together. A single observation
    # is one window of one (the JAX package takes its dense solve there; the
    # QP is the same)
    windows = resolve_windows(num_obs, batch_size, overlap)
    batch_size = windows[0][1] - windows[0][0]
    systems, metas = [], []
    for start, end in windows:
        p_stack, q_stack, lb, my, cmat, meta = blocks(order[start:end])
        systems.append((p_stack, q_stack, lb, my, cmat))
        metas.append(meta)
    if batched:
        xs, info = resolve_mod.solve_resolve_batch(systems, **solve_kw)
    else:
        xs, info = solve_dense_windows(systems, dtype=dtype, device=device)
    info = {"coupled": False, "windows": len(windows), **info}

    n_cols = tau_indices[1] - tau_indices[0]
    x_batch = np.zeros((len(windows), num_obs, n_cols))
    sp_batch = {}
    margins = np.full((len(windows), num_obs), -1.0)
    x_res = np.zeros((num_obs, n_cols))
    sp_res = {}
    for i, (x_win, (special_dict, _, _, _)) in enumerate(zip(xs, metas)):
        start, end = windows[i]
        bidx = order[start:end]
        x_drt, x_sp = unpack(np.asarray(x_win), bidx, special_dict)
        # later windows overwrite earlier ones where nothing is averaged
        x_res[bidx] = x_drt
        x_batch[i, start:end] = x_drt
        for key, val in x_sp.items():
            sp_res.setdefault(key, np.zeros((num_obs, *val.shape[1:])))[bidx] = val
            sp_batch.setdefault(key, np.zeros((len(windows), num_obs, *val.shape[1:])))
            sp_batch[key][i, start:end] = val
        margins[i, start:end] = np.minimum(np.arange(batch_size), np.arange(batch_size)[::-1])

    # Overlap averaging with the reference's margin weights (drtmd.py:1573),
    # in psi order; results go back to the batch's order
    if overlap > 0 and num_obs > 1:
        weights = margins + 0.1
        weights[weights < 0] = 0
        x_sorted = np.average(x_batch, axis=0,
                              weights=np.broadcast_to(weights[..., None], x_batch.shape))
        x_res[order] = x_sorted
        for key, val in sp_batch.items():
            w_k = weights if val.ndim == 2 else np.broadcast_to(weights[..., None], val.shape)
            sp_res[key][order] = np.average(val, axis=0, weights=w_k)
    return GroupResolveResult(x_res, sp_res, tau_indices, order, info)


# ---------------------------------------------------------------------------
# The map class (hybdrt_tpu/mapping/drtmd.py:32-1585, its batched parts)
# ---------------------------------------------------------------------------
# Marks a fitter cache key component that cannot be hashed reliably
# (non-primitive fit kwargs): the fitter is built fresh and never cached
_UNCACHEABLE = object()


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _no_reader(file):
    raise NotImplementedError(f"reading {file!r}: the file readers (fileload) are not ported yet "
                              f"(ROADMAP, Host modules); pass the data as arrays")


class DRTMD:
    """Observations at coordinates psi on one tau supergrid, their batched
    fits and the group resolve.

    Usage:
        md = DRTMD(tau_supergrid, psi_dim_names=["T"])   # on the CUDA card
        md.add_observation([t], None, (freq, z), group_id="g")
        md.add_observation([t], (times, i_signal, v_signal), (freq, z), group_id="g")
        md.fit_all(batched=True, dtype=torch.float32)
        md.resolve_group("g", psi_sort_dims=["T"], coupled=True)
        md.obs_x, md.obs_special, md.obs_x_resolved, md.obs_special_resolved

    ``device`` is the card unless ``device="cpu"``; the fits run there in
    ``fit_all``'s ``dtype`` (float64 by default), the (P, q) rebuild in
    float64, the resolve in ``resolve_group``'s ``dtype``. ``batch_fit_kw``
    goes to every batched fitter: the constructor knobs (``qp_max_iter``,
    ``qp_max_iter_warm``, ``pred_stop``, ...) and the fit calls' ``adaptive``
    (every mode runs the port's live-lane loop). The read side runs on the
    host as the JAX class's does: predictions (``predict_x``, ``predict_drt``
    at any derivative order, ``predict_r_p``, ``predict_special``), filters
    and QC (``filter_observations``, ``score_group_fit_badness``) and
    persistence (``save_attributes``, ``load_attributes``, ``from_source``,
    whose files the JAX class reads and writes too), and its covariance
    readouts (``predict_param_cov``, ``predict_drt_var``,
    ``predict_peak_prob``, ...). ``fit_all()`` (``batched=False``, the
    reference's default) fits each observation with ``self.drt1d`` in
    float64 on the map's device and stores the ``store_attr_categories`` of
    its attributes (any of "config", "fit_core" and "detail": the fit's
    history where one was stored, ``pfrt_result`` None, and its fit
    matrices). PFRT and the mesh are not ported; each raises
    ``NotImplementedError`` naming its ROADMAP item, or is absent.
    ``print_progress`` prints the serial fit's progress;
    ``print_diagnostics`` is kept for the JAX class's signature;
    ``fit_dop`` fits the distribution of phasances (``fixed_basis_nu``,
    ``nu_basis_type``, ``nu_epsilon`` and ``normalize_dop`` configure it;
    ``obs_special["x_dop"]``, ``predict_dop``), ``fit_capacitance`` the
    inverse capacitance (``obs_special["C_inv"]``); with either, hybrid
    observations go to the ragged fitter, as in the JAX class.
    ``pfrt_factors`` configures the PFRT (item 9).
    """

    def __init__(self, tau_supergrid, psi_dim_names=None, store_attr_categories=None,
                 extend_basis_decades=1, tau_basis_type="gaussian", tau_epsilon=None,
                 step_model="ideal", chrono_mode="galv", fit_inductance=True, fit_ohmic=True,
                 fit_capacitance=False, fixed_basis_nu=None, fit_dop=False, normalize_dop=True,
                 nu_basis_type="gaussian", nu_epsilon=None, chrono_reader=None, eis_reader=None,
                 fit_kw=None, fit_type="drt", pfrt_factors=None, batch_fit_kw=None,
                 print_diagnostics=False, print_progress=True, warn=False, device=None):
        if fit_type not in ("drt", "pfrt"):
            raise ValueError(f"Invalid fit_type {fit_type}. Options: ['drt', 'pfrt']")
        if fit_type == "pfrt":
            raise _unported("fit_type='pfrt': the PFRT sweep", 9)
        if store_attr_categories is None:
            store_attr_categories = ["config", "fit_core"]
        self.device = resolve_device(device)
        self.drt1d = DRT(tau_supergrid=tau_supergrid, tau_basis_type=tau_basis_type,
                         tau_epsilon=tau_epsilon, extend_basis_decades=extend_basis_decades, step_model=step_model,
                         chrono_mode=chrono_mode, fit_inductance=fit_inductance,
                         fit_ohmic=fit_ohmic, fit_capacitance=fit_capacitance, fit_dop=fit_dop,
                         fixed_basis_nu=fixed_basis_nu, nu_basis_type=nu_basis_type,
                         nu_epsilon=nu_epsilon, normalize_dop=normalize_dop, warn=warn,
                         device=self.device)

        self.psi_dim_names = psi_dim_names
        self.store_attr_categories = list(store_attr_categories)
        self.tau_supergrid = np.asarray(tau_supergrid)
        self.tau_basis_type = tau_basis_type
        self.tau_epsilon = self.drt1d.tau_epsilon
        self.fit_inductance = fit_inductance
        self.fit_ohmic = fit_ohmic
        self.fit_capacitance = fit_capacitance
        self.fixed_basis_nu = fixed_basis_nu
        self.nu_basis_type = nu_basis_type
        self.nu_epsilon = nu_epsilon
        self.fit_dop = fit_dop
        self.normalize_dop = normalize_dop
        self.step_model = step_model
        self.chrono_mode = chrono_mode
        self.batch_fit_kw = dict(batch_fit_kw or {})
        self.chrono_reader = chrono_reader or _no_reader
        self.eis_reader = eis_reader or _no_reader
        self.fit_type = fit_type
        self.pfrt_factors = pfrt_factors
        fit_kw = dict(fit_kw or {})
        fit_kw.setdefault("nonneg", True)
        self.fit_kw = fit_kw

        # Observation store
        self.obs_psi = None if psi_dim_names is None else np.zeros((0, len(psi_dim_names)))
        self.obs_data = []
        self.obs_group_id = []
        self.obs_data_badness = np.zeros(0)
        self.obs_ignore_flag = np.zeros(0, dtype=bool)

        # Fit results
        self.obs_x = np.zeros((0, *self.drt_param_shape()))
        self.obs_drt_var = np.zeros((0, len(self.tau_supergrid)))
        self.obs_special = None
        self.obs_fit_attr = []
        self.obs_fit_status = np.zeros(0, dtype=bool)
        self.obs_fit_errors = []
        self.obs_fit_badness = np.zeros(0)
        self.obs_tau_indices = []
        self.obs_llh = np.zeros(0)
        self.obs_rss = np.zeros(0)

        # Resolved results; resolve_info holds the last resolve's diagnostics
        self.obs_resolve_status = np.zeros(0, dtype=bool)
        self.obs_x_resolved = np.zeros((0, len(self.tau_supergrid)))
        self.obs_special_resolved = None
        self.obs_x_filt = np.zeros((0, len(self.tau_supergrid)))
        self.obs_special_filt = None
        self.resolve_info = None

        self.print_diagnostics = print_diagnostics
        self.print_progress = print_progress
        self.warn = warn

    # ------------------------------------------------------------------
    # The observation store (:141-232)
    # ------------------------------------------------------------------
    @property
    def num_obs(self):
        return len(self.obs_data)

    def drt_param_shape(self):
        return (len(self.tau_supergrid),)

    def special_param_shape(self, key):
        size = self.drt1d.special_qp_params.get(key, {"size": 1}).get("size", 1)
        return () if size == 1 else (size,)

    def validate_psi(self, psi):
        if self.psi_dim_names is not None and len(psi) != len(self.psi_dim_names):
            raise ValueError(f"psi must have {len(self.psi_dim_names)} entries")

    def add_observation(self, psi, chrono_data, eis_data, group_id=None, fit=False):
        """Store an observation (:164), and with ``fit`` fit it at once."""
        psi = np.atleast_1d(psi).flatten()
        if self.obs_psi is None:
            self.obs_psi = np.zeros((0, len(psi)))
        self.validate_psi(psi)
        n = self.num_obs
        self.obs_psi = np.insert(self.obs_psi, n, psi, axis=0)
        self.obs_data.append((chrono_data, eis_data))
        self.obs_data_badness = np.append(self.obs_data_badness, 0)
        self.obs_group_id.append(group_id)
        self.obs_ignore_flag = np.append(self.obs_ignore_flag, False)
        self.obs_fit_status = np.append(self.obs_fit_status, False)
        self.obs_fit_errors.append(None)
        self.obs_fit_badness = np.append(self.obs_fit_badness, 0)
        self.obs_fit_attr.append(None)
        self.obs_tau_indices.append(None)
        zero_row = np.zeros((1, *self.drt_param_shape()))
        zero_flat = np.zeros((1, len(self.tau_supergrid)))
        self.obs_x = np.concatenate([self.obs_x, zero_row])
        self.obs_drt_var = np.concatenate([self.obs_drt_var, zero_flat])
        self.obs_x_resolved = np.concatenate([self.obs_x_resolved, zero_flat])
        self.obs_x_filt = np.concatenate([self.obs_x_filt, zero_flat])
        self.obs_llh = np.append(self.obs_llh, 0)
        self.obs_rss = np.append(self.obs_rss, 0)
        self.obs_resolve_status = np.append(self.obs_resolve_status, False)
        if self.obs_special is not None:
            for key in self.obs_special:
                shape = (1, *self.special_param_shape(key))
                for d in (self.obs_special, self.obs_special_resolved, self.obs_special_filt):
                    d[key] = np.concatenate([d[key], np.zeros(shape)])
        if fit:
            self.fit_observation(self.num_obs - 1)

    def add_observations(self, psi_array, chrono_data_list=None, eis_data_list=None,
                         group_ids=None):
        n = len(psi_array)
        chrono_data_list = chrono_data_list or [None] * n
        eis_data_list = eis_data_list or [None] * n
        group_ids = group_ids if group_ids is not None else [None] * n
        for psi, cd, ed, gid in zip(psi_array, chrono_data_list, eis_data_list, group_ids):
            self.add_observation(psi, cd, ed, group_id=gid)

    def get_obs_data(self, obs_index):
        chrono_data, eis_data = self.obs_data[obs_index]
        if isinstance(chrono_data, (str, Path)):
            chrono_data = self.chrono_reader(chrono_data)
        elif chrono_data is None:
            chrono_data = (None, None, None)
        if isinstance(eis_data, (str, Path)):
            eis_data = self.eis_reader(eis_data)
        elif eis_data is None:
            eis_data = (None, None)
        return chrono_data, eis_data

    def initialize_obs_special(self):
        self.obs_special, self.obs_special_resolved, self.obs_special_filt = {}, {}, {}
        for key in self.drt1d.special_qp_params:
            self._add_special_key(key)

    def _add_special_key(self, key):
        shape = (self.num_obs, *self.special_param_shape(key))
        for d in (self.obs_special, self.obs_special_resolved, self.obs_special_filt):
            d[key] = np.zeros(shape)

    def format_1d_params(self, drt, left_index, right_index):
        """A fitted DRT's coefficients on the supergrid (its basis at
        [left_index, right_index)) and its special parameters (:234)."""
        x_drt = np.zeros(len(self.tau_supergrid))
        x_drt[left_index:right_index] = drt.fit_parameters["x"]
        x_special = {k: drt.fit_parameters.get(k) for k in drt.special_qp_params}
        if "v_baseline" in drt.special_qp_params:
            x_special["v_baseline"] = np.atleast_1d(drt.fit_parameters["v_baseline"])
            if self.special_param_shape("v_baseline") == ():
                x_special["v_baseline"] = x_special["v_baseline"][0]
        return x_drt, x_special

    # ------------------------------------------------------------------
    # The distribution variance and the serial fits (:262-482)
    # ------------------------------------------------------------------
    def estimate_obs_drt_var(self, obs_index=None, refresh=False):
        """Fill ``obs_drt_var`` (the variance of each fit's distribution on
        the supergrid, extrapolated beyond its basis) for batched fits; the
        serial fits store it as they fit (:262). A uniform-batched group's P
        are rebuilt and inverted in one batched float64 inverse on the map's
        device (``_estimate_drt_var_group``); the other observations go
        through one ``get_fits_batched`` rebuild and one batched inverse per
        size of P, which gives what each fit's
        ``estimate_distribution_cov(tau=tau_supergrid, extend_var=True)``
        gives."""
        if obs_index is None:
            obs_index = np.where(self.obs_fit_status)[0]
        groups, slow = {}, []
        for i in np.atleast_1d(obs_index):
            i = int(i)
            if not refresh and np.any(self.obs_drt_var[i] != 0):
                continue
            attr = self.obs_fit_attr[i]
            if self.obs_fit_status[i] and not (isinstance(attr, dict) and attr.get("batched")):
                continue
            key = self._uniform_group_key(i)
            if key is None:
                slow.append(i)
            else:
                groups.setdefault(key, []).append(i)
        for idx in groups.values():
            if len(idx) == 1:
                slow.extend(idx)
            else:
                slow.extend(self._estimate_drt_var_group(idx))
        if slow:
            fits = self.get_fits_batched(slow)
            for i, cov in self._param_covs(fits, slow).items():
                self.obs_drt_var[i] = np.diag(fits[i].distribution_cov(
                    cov, self.tau_supergrid, extend_var=True))
        return self.obs_drt_var

    def _estimate_drt_var_group(self, idx):
        """obs_drt_var of uniform-batched observations of one fitter (:300):
        every P rebuilt (``_uniform_pq``) and inverted in one batched
        float64 ``invert_psd`` on the map's device, the basis-to-supergrid
        transform's diagonal taken there, then the out-of-basis
        extrapolation on the host. Returns the observations whose variance
        came out non-finite, for the per-observation path."""
        attrs = [self.obs_fit_attr[i] for i in idx]
        fitter = self._resolve_batch_fitter(idx[0], attrs[0])
        basis_tau = np.asarray(fitter.basis_tau)
        ns = fitter.num_special
        p_b, _ = self._uniform_pq(fitter, attrs)
        cov = mat1d.invert_psd(p_b)[:, ns:, ns:]
        # the fitter's basis, gaussian (Queue 3 item 27)
        em = torch.tensor(basis_mod.func_eval_matrix_host(
            np.log(basis_tau), np.log(self.tau_supergrid), "gaussian",
            fitter.tau_epsilon, 0), dtype=cov.dtype, device=cov.device)
        var = torch.einsum("tj,bjk,tk->bt", em, cov, em).cpu().numpy()
        var = var * np.array([float(a["scale"]) for a in attrs])[:, None] ** 2
        tau = np.asarray(self.tau_supergrid)
        left, right = tau < basis_tau[0], tau > basis_tau[-1]
        if left.any() and (~left).any():
            var[:, left] += var[:, ~left][:, :1] * np.log(basis_tau[0] / tau[left])[None] ** 2
        if right.any() and (~right).any():
            var[:, right] += var[:, ~right][:, -1:] * np.log(tau[right] / basis_tau[-1])[None] ** 2
        bad = ~np.all(np.isfinite(var), axis=1)
        for bi, i in enumerate(idx):
            if not bad[bi]:
                self.obs_drt_var[i] = var[bi]
        return [i for bi, i in enumerate(idx) if bad[bi]]

    def fit_convergence_summary(self):
        """Per observation ``converged`` (False where unfitted or failed;
        True for a serial fit, which warns as it fits) and ``n_iter`` (-1
        where unknown), the failures ``ignore_errors`` recorded, and counts
        (:365)."""
        n = self.num_obs
        converged = np.zeros(n, dtype=bool)
        n_iter = np.full(n, -1, dtype=int)
        for i in range(n):
            attr = self.obs_fit_attr[i] if i < len(self.obs_fit_attr) else None
            if isinstance(attr, dict) and attr.get("batched"):
                converged[i] = attr.get("converged", False)
                n_iter[i] = attr.get("n_iter", -1)
            elif self.obs_fit_status[i]:
                converged[i] = True
        errors = [str(e) if e is not None else None for e in self.obs_fit_errors]
        return {"converged": converged, "n_iter": n_iter, "errors": errors,
                "num_fitted": int(np.sum(self.obs_fit_status)),
                "num_failed": int(sum(e is not None for e in self.obs_fit_errors)),
                "num_converged": int(np.sum(converged))}

    def fit_observation(self, obs_index, ignore_errors=False):
        """Fit one observation with ``self.drt1d`` (``fit_eis``, ``fit_chrono``
        or ``fit_hybrid`` with ``fit_kw``; float64 on the map's device) and
        store its coefficients, special parameters, attributes, llh, rss and
        distribution variance (:394). With ``ignore_errors`` a failure marks
        the observation ignored."""
        chrono_data, eis_data = self.get_obs_data(obs_index)
        try:
            times, freq = chrono_data[0], eis_data[0]
            if times is None and freq is None:
                raise ValueError("Observation has no data")
            if times is None:
                self.drt1d.fit_eis(*eis_data, **self.fit_kw)
            elif freq is None:
                self.drt1d.fit_chrono(*chrono_data, **self.fit_kw)
            else:
                self.drt1d.fit_hybrid(*chrono_data, *eis_data, **self.fit_kw)

            self.obs_fit_attr[obs_index] = self.drt1d.get_attributes(
                which=self.store_attr_categories)
            self.obs_llh[obs_index] = self.drt1d.evaluate_llh()
            self.obs_rss[obs_index] = self.drt1d.evaluate_rss()
            left = pp.nearest_index(self.tau_supergrid, self.drt1d.basis_tau[0])
            right = pp.nearest_index(self.tau_supergrid, self.drt1d.basis_tau[-1]) + 1
            self.obs_tau_indices[obs_index] = (left, right)
            if self.obs_special is None:
                self.initialize_obs_special()
            x_drt, x_special = self.format_1d_params(self.drt1d, left, right)
            if not np.all(np.isfinite(x_drt)):
                raise ValueError("Fit produced non-finite DRT coefficients")
            self.obs_x[obs_index] = x_drt
            self.obs_drt_var[obs_index] = np.diag(self.drt1d.estimate_distribution_cov(
                tau=self.tau_supergrid, extend_var=True))
            for key in self.drt1d.special_qp_params:
                if key not in self.obs_special:
                    self._add_special_key(key)
                self.obs_special[key][obs_index] = x_special[key]
            self.obs_fit_status[obs_index] = True
        except Exception as err:
            if not ignore_errors:
                raise
            print(f"Error at obs_index {obs_index}; observation ignored.\n{err}")
            self.obs_fit_status[obs_index] = False
            self.obs_ignore_flag[obs_index] = True
            self.obs_fit_errors[obs_index] = err

    def fit_observations(self, obs_index, print_interval=None, ignore_errors=False):
        """``fit_observation`` of each of ``obs_index`` in turn (:453),
        printing progress every ``print_interval`` with ``print_progress``."""
        num_to_fit = len(obs_index)
        if print_interval is None:
            print_interval = int(np.ceil(num_to_fit / 10)) if num_to_fit else 1
        start_time = time.time()
        for i, index in enumerate(obs_index):
            self.fit_observation(index, ignore_errors=ignore_errors)
            if self.print_progress and ((i + 1) % print_interval == 0 or i == num_to_fit - 1):
                print(f"{i + 1} / {num_to_fit}")
        if num_to_fit > 0 and self.print_progress:
            elapsed = time.time() - start_time
            print(f"Fitted {num_to_fit} observations in {elapsed:.1f} s "
                  f"({elapsed / num_to_fit:.2f} s/obs)")

    def fit_all(self, refit=False, print_interval=None, ignore_errors=False, batched=False,
                mesh=None, dtype=None):
        """Fit every observation not fitted yet (``refit``: every one), one
        by one (``fit_observations``, the reference's default; float64) or
        with ``batched`` as batches partitioned by data type
        (``_fit_batched``; ``dtype`` a torch dtype, float64 by default)."""
        if mesh is not None:
            raise _unported("mesh: multi-GPU sharding", 10)
        if refit:
            fit_index = np.arange(self.num_obs)
        else:
            fit_index = np.where(~self.obs_fit_status & ~self.obs_ignore_flag)[0]
        if batched:
            self._fit_batched(fit_index, dtype=dtype, ignore_errors=ignore_errors)
        else:
            self.fit_observations(fit_index, print_interval, ignore_errors)

    def _fit_batched(self, fit_index, dtype=None, ignore_errors=False):
        """Partition by data type (:484-555): a uniform EIS grid goes to the
        shared-grid EIS fitter, a uniform hybrid protocol with the default
        weight factors to the shared-protocol hybrid fitter, everything else
        (other grids and protocols, chrono-only data) to the ragged fitter."""
        if len(fit_index) == 0:
            return
        fit_index = np.asarray(fit_index)
        chronos, eiss, types = [], [], []
        for i in fit_index:
            chrono_data, eis_data = self.get_obs_data(i)
            has_c = chrono_data is not None and chrono_data[0] is not None
            has_e = eis_data is not None and eis_data[0] is not None
            if not (has_c or has_e):
                raise ValueError(f"Observation {i} has no data")
            chronos.append(chrono_data)
            eiss.append(eis_data)
            types.append("hybrid" if (has_c and has_e) else ("eis" if has_e else "chrono"))
        types = np.array(types)
        wf_default = (self.fit_kw.get("hybrid_weight_factor_method") is None
                      and self.fit_kw.get("eis_weight_factor") is None
                      and self.fit_kw.get("chrono_weight_factor") is None
                      and not self.fit_dop and not self.fit_capacitance)
        for type_name in ("eis", "hybrid", "chrono"):
            sel = types == type_name
            if not sel.any():
                continue
            idx = fit_index[sel]
            sub_c = [c for c, m in zip(chronos, sel) if m]
            sub_e = [e for e, m in zip(eiss, sel) if m]
            if type_name == "eis" and self._eis_grid_uniform(sub_e):
                self._fit_batched_eis_uniform(idx, sub_e, dtype, ignore_errors)
            elif type_name == "hybrid" and wf_default \
                    and self._hybrid_protocol_uniform(sub_c, sub_e):
                self._fit_batched_hybrid_uniform(idx, sub_c, sub_e, dtype, ignore_errors)
            else:
                self._fit_batched_ragged(idx, sub_c, sub_e, dtype, ignore_errors)

    def _batched_obs_failure(self, obs_index, reason, ignore_errors):
        """A non-finite lane: raise, or with ``ignore_errors`` mark the
        observation ignored (:557)."""
        err = ValueError(reason)
        if not ignore_errors:
            raise err
        print(f"Error at obs_index {obs_index}; observation ignored.\n{err}")
        self.obs_fit_status[obs_index] = False
        self.obs_ignore_flag[obs_index] = True
        self.obs_fit_errors[obs_index] = err

    @staticmethod
    def _eis_grid_uniform(eiss):
        f0 = np.asarray(eiss[0][0])
        return all(len(np.asarray(e[0])) == len(f0) and np.allclose(e[0], f0) for e in eiss[1:])

    @staticmethod
    def _hybrid_protocol_uniform(chronos, eiss):
        if not DRTMD._eis_grid_uniform(eiss):
            return False
        t0, i0 = np.asarray(chronos[0][0]), np.asarray(chronos[0][1])
        return all(len(np.asarray(c[0])) == len(t0) and np.allclose(c[0], t0)
                   and np.allclose(c[1], i0) for c in chronos[1:])

    def _fit_batched_eis_uniform(self, fit_index, eiss, dtype, ignore_errors):
        f0 = np.asarray(eiss[0][0])
        z_batch = np.stack([np.asarray(e[1]) for e in eiss])
        fitter = self._eis_fitter(f0, dtype=dtype)
        result = fitter.fit(z_batch, **self._split_batch_kw()[1])
        self._batch_fitter = fitter
        self._register_batch_fitter("eis", fitter)
        rzv_batch, _ = fitter.scale_batch(z_batch)
        self._store_uniform_result(fit_index, fitter, result, z_batch, rzv_batch, False,
                                   ignore_errors)

    def _fit_batched_hybrid_uniform(self, fit_index, chronos, eiss, dtype, ignore_errors):
        f0 = np.asarray(eiss[0][0])
        z_batch = np.stack([np.asarray(e[1]) for e in eiss])
        t0, i0 = np.asarray(chronos[0][0]), np.asarray(chronos[0][1])
        v_batch = np.stack([np.asarray(c[2]) for c in chronos])
        fitter = self._hybrid_fitter(t0, i0, f0, dtype=dtype)
        result = fitter.fit(v_batch, z_batch, **self._split_batch_kw()[1])
        self._batch_fitter = fitter
        self._register_batch_fitter("hybrid", fitter)
        rzv_batch, _ = fitter.scale_batch(v_batch, z_batch)
        self._store_uniform_result(fit_index, fitter, result, z_batch, rzv_batch, True,
                                   ignore_errors)

    def _register_batch_fitter(self, key, fitter):
        """One fitter per batched kind, so that each can rebuild its own
        observations (:615)."""
        if not hasattr(self, "_batch_fitters"):
            self._batch_fitters = {}
        self._batch_fitters[key] = fitter

    # batch_fit_kw keys taken by the fit calls, not the constructors
    _SCHEDULE_KEYS = ("adaptive", "phase_budgets", "staged_capacities")

    def _split_batch_kw(self):
        """(constructor kwargs, fit-call kwargs) of batch_fit_kw."""
        ctor = {k: v for k, v in self.batch_fit_kw.items() if k not in self._SCHEDULE_KEYS}
        sched = {k: v for k, v in self.batch_fit_kw.items() if k in self._SCHEDULE_KEYS}
        return ctor, sched

    def _batch_kw_sig(self):
        """A hashable signature of batch_fit_kw for the fitter cache key, or
        _UNCACHEABLE when a value is not a primitive or a flat sequence."""
        def scalar(x):
            return isinstance(x, (str, int, float, bool, type(None)))

        def prim(v):
            return all(scalar(x) for x in v) if isinstance(v, (list, tuple)) else scalar(v)

        kw = self.batch_fit_kw
        if all(prim(v) for v in kw.values()):
            return tuple(sorted(((k, tuple(v) if isinstance(v, (list, tuple)) else v)
                                 for k, v in kw.items()), key=lambda kv: kv[0]))
        return _UNCACHEABLE

    def _struct_sig(self):
        """The model configuration the fitters are assembled from: part of
        every cache key, so that changing it between fit_all calls builds
        new fitters (:651)."""
        return (np.asarray(self.tau_supergrid, dtype=float).tobytes(), bool(self.fit_ohmic),
                bool(self.fit_inductance), bool(self.fit_capacitance), bool(self.fit_dop),
                str(self.step_model), str(self.chrono_mode))

    def _cached_fitter(self, key, factory):
        """Reuse a fitter across fit_all calls (its protocol caches and
        uploaded matrices); a key holding _UNCACHEABLE builds a fresh one,
        never stored (:664)."""
        if any(k is _UNCACHEABLE for k in key):
            return factory()
        cache = getattr(self, "_fitter_cache", None)
        if cache is None:
            cache = self._fitter_cache = {}
        fitter = cache.get(key)
        if fitter is None:
            fitter = cache[key] = factory()
        return fitter

    def _eis_fitter(self, f0, dtype=None):
        """The shared-grid EIS fitter of this map's configuration (cached)."""
        f0 = np.asarray(f0)
        dtype = torch.float64 if dtype is None else dtype
        ctor_kw, _ = self._split_batch_kw()
        nonneg = self.fit_kw.get("nonneg", True)
        return self._cached_fitter(
            ("eis", f0.tobytes(), str(dtype), bool(nonneg), self._batch_kw_sig(),
             self._struct_sig()),
            lambda: BatchedEISFitter(f0, tau_supergrid=self.tau_supergrid,
                                     fit_ohmic=self.fit_ohmic, fit_inductance=self.fit_inductance,
                                     fit_capacitance=self.fit_capacitance, fit_dop=self.fit_dop,
                                     nonneg=nonneg, dtype=dtype, device=self.device, **ctor_kw))

    def _hybrid_fitter(self, t0, i0, f0, dtype=None):
        """The shared-protocol hybrid fitter of this map's configuration
        (cached)."""
        t0, i0, f0 = (np.asarray(a, dtype=float) for a in (t0, i0, f0))
        dtype = torch.float64 if dtype is None else dtype
        ctor_kw, _ = self._split_batch_kw()
        nonneg = self.fit_kw.get("nonneg", True)
        return self._cached_fitter(
            ("hybrid", t0.tobytes(), i0.tobytes(), f0.tobytes(), str(dtype), bool(nonneg),
             self._batch_kw_sig(), self._struct_sig()),
            lambda: BatchedHybridFitter(t0, i0, f0, tau_supergrid=self.tau_supergrid,
                                        fit_ohmic=self.fit_ohmic,
                                        fit_inductance=self.fit_inductance, nonneg=nonneg,
                                        dtype=dtype, device=self.device, **ctor_kw))

    def _ragged_fitter_kw(self):
        return dict(fit_ohmic=self.fit_ohmic, fit_inductance=self.fit_inductance,
                    fit_capacitance=self.fit_capacitance, fit_dop=self.fit_dop,
                    fixed_basis_nu=self.fixed_basis_nu,
                    nonneg=self.fit_kw.get("nonneg", True), device=self.device,
                    step_model=self.step_model, chrono_mode=self.chrono_mode,
                    fit_kw={k: v for k, v in self.fit_kw.items() if k != "nonneg"},
                    **self._split_batch_kw()[0])

    def _special_drt(self, tau_basis_type="gaussian"):
        """A DRT of this map's configuration, its nu basis set as a fit sets
        it, to carry a batched fit (:1070, :1327): a ragged fit's carries the
        map's basis, a shared-grid fitter's the gaussian of its template, as
        in the JAX package, whose batched fitters fit the gaussian basis
        whatever the map's (ROADMAP Queue 3 item 27)."""
        drt = DRT(tau_supergrid=self.tau_supergrid, tau_basis_type=tau_basis_type,
                  fit_ohmic=self.fit_ohmic,
                  fit_inductance=self.fit_inductance, fit_capacitance=self.fit_capacitance,
                  fit_dop=self.fit_dop, fixed_basis_nu=self.fixed_basis_nu,
                  nu_basis_type=self.nu_basis_type, nu_epsilon=self.nu_epsilon,
                  normalize_dop=self.normalize_dop, step_model=self.step_model,
                  chrono_mode=self.chrono_mode, warn=False, device=self.device)
        if self.fit_dop:
            drt.basis_nu = default_basis_nu(self.fixed_basis_nu)
            drt.nu_epsilon = default_nu_epsilon(drt.basis_nu, self.nu_basis_type,
                                                self.nu_epsilon)
        return drt

    def _fitter_template(self, fitter, is_hybrid):
        """A DRT holding the configuration of a shared-grid fitter's problem,
        where the JAX package reads its fitters' template fit."""
        drt = self._special_drt()
        drt.basis_tau = np.asarray(fitter.basis_tau)
        drt.tau_epsilon = fitter.tau_epsilon
        drt.special_qp_params = dict(fitter.special_qp_params)
        drt.inductance_scale = fitter.inductance_scale
        drt.capacitance_scale = fitter.capacitance_scale
        drt.dop_scale_vector = fitter.dop_scale_vector
        drt.f_fit = fitter.frequencies
        drt.fit_type = "qphb_hybrid" if is_hybrid else "qphb_eis"
        if is_hybrid:
            drt.t_fit = fitter.times
            drt.step_times, drt.step_sizes = fitter.step_times, fitter.step_sizes
            drt.input_signal_scale = fitter.input_signal_scale
            drt.v_baseline_scale = fitter.v_baseline_scale
            drt.v_baseline_deg, drt.v_baseline_sqrt = 0, False
        return drt

    def _store_uniform_result(self, fit_index, fitter, result, z_batch, rzv_batch, is_hybrid,
                              ignore_errors=False):
        """Store a shared-grid fit (:735-802): coefficients on the fitter's
        window of the supergrid, the per-observation state the (P, q)
        rebuild needs, and the weighted scaled-space rss and llh, a hybrid
        fit's model with its final vz-offset column."""
        left = pp.nearest_index(self.tau_supergrid, fitter.basis_tau[0])
        right = pp.nearest_index(self.tau_supergrid, fitter.basis_tau[-1]) + 1
        self.drt1d.set_attributes(self._fitter_template(fitter, is_hybrid).get_attributes(
            ["config", "fit_core"]))
        if self.obs_special is None:
            self.initialize_obs_special()
        for bi, i in enumerate(fit_index):
            if not (np.all(np.isfinite(result.x[bi])) and np.isfinite(result.r_inf[bi])):
                self._batched_obs_failure(i, "Batched fit produced non-finite coefficients",
                                          ignore_errors)
                continue
            self.obs_x[i, left:right] = result.x[bi]
            self.obs_tau_indices[i] = (left, right)
            if "R_inf" in self.obs_special:
                self.obs_special["R_inf"][i] = result.r_inf[bi]
            if "inductance" in self.obs_special:
                self.obs_special["inductance"][i] = result.inductance[bi]
            self._store_dop_cap(i, result, bi)
            self.obs_fit_attr[i] = {
                "batched": True, "x_raw": result.x_raw[bi], "scale": result.scale[bi],
                "weights": result.weights[bi], "rho": result.rho[bi],
                "s_vectors": result.s_vectors[bi], "z": z_batch[bi],
                "rzv": np.asarray(rzv_batch[bi]), "fitter_key": "hybrid" if is_hybrid else "eis",
                "converged": bool(result.converged[bi]), "n_iter": int(result.n_iter[bi]),
            }
            self.obs_fit_status[i] = True

        # The model in the fit's dtype, as the JAX package takes it
        np_ = lambda a: a.detach().cpu().numpy()
        x_raw = np.asarray(result.x_raw)
        y_hat = x_raw @ np_(fitter.rzm).T
        if is_hybrid and fitter.vz_offset:
            y_sep = x_raw @ np_(fitter.hybrid["rzm_vz"]).T
            y_sep[:, fitter.num_chrono:] *= -1.0
            y_hat = y_hat + x_raw[:, [fitter.vz_index]] * y_sep \
                * np_(fitter.hybrid["vz_strength"])[None, :]
        rzv = np.asarray(rzv_batch)
        weights = np.asarray(result.weights)
        rss = np.sum((weights * (y_hat - rzv)) ** 2, axis=1)
        alpha_n = 2.0 - 1 + rzv.shape[1] / 2
        llh = (-alpha_n * np.log(1.0 + 0.5 * rss) + gammaln(alpha_n) - gammaln(2.0)
               + np.sum(np.log(np.maximum(weights, 1e-300)), axis=1))
        ok = self.obs_fit_status[fit_index]
        self.obs_rss[fit_index[ok]] = rss[ok]
        self.obs_llh[fit_index[ok]] = llh[ok]

    def _store_dop_cap(self, i, result, bi):
        """A batched fit's C_inv and x_dop into obs_special (:761-764)."""
        if "C_inv" in self.obs_special:
            self.obs_special["C_inv"][i] = result.c_inv[bi]
        if "x_dop" in self.obs_special and result.x_dop is not None:
            self.obs_special["x_dop"][i] = result.x_dop[bi]

    def _fit_batched_ragged(self, fit_index, chronos, eiss, dtype, ignore_errors):
        """Observations on grids and protocols of their own, padded and
        masked into one batch (:804-894)."""
        fit_kw = {k: v for k, v in self.fit_kw.items() if k != "nonneg"}
        fitter = self._cached_fitter(
            ("ragged", None if dtype is None else str(dtype),
             bool(self.fit_kw.get("nonneg", True)), self._batch_kw_sig(), self._struct_sig(),
             tuple(sorted(fit_kw.items(), key=lambda kv: kv[0]))
             if all(isinstance(v, (str, int, float, bool, type(None))) for v in fit_kw.values())
             else _UNCACHEABLE),
            lambda: BatchedRaggedFitter(self.tau_supergrid,
                                        dtype=torch.float64 if dtype is None else dtype,
                                        **self._ragged_fitter_kw()))
        result = fitter.fit(list(zip(chronos, eiss)), **self._split_batch_kw()[1])
        self._ragged_fitter = fitter
        if self.obs_special is None:
            self.drt1d.special_qp_params = fitter.special_qp_params
            self.initialize_obs_special()

        # Scaled-space weighted rss and llh over each observation's own rows
        ns = fitter.cfg.num_special
        row_mask = fitter.full("row_mask")
        wr = result.weights * (fitter.final_predictions(result) - fitter._last_batch["rzv"]) \
            * row_mask
        rss = np.sum(wr ** 2, axis=1)
        alpha_n = 2.0 - 1 + row_mask.sum(axis=1) / 2
        llh = (-alpha_n * np.log(1.0 + 0.5 * rss) + gammaln(alpha_n) - gammaln(2.0)
               + np.sum(row_mask * np.log(np.maximum(result.weights, 1e-300)), axis=1))

        for bi, i in enumerate(fit_index):
            li, ri = result.tau_indices[bi]
            w_i = ri - li
            if not (np.all(np.isfinite(result.x[bi][:w_i])) and np.isfinite(result.r_inf[bi])):
                self._batched_obs_failure(
                    i, "Batched ragged fit produced non-finite coefficients", ignore_errors)
                continue
            self.obs_x[i, li:ri] = result.x[bi][:w_i]
            self.obs_tau_indices[i] = (li, ri)
            if "R_inf" in self.obs_special:
                self.obs_special["R_inf"][i] = result.r_inf[bi]
            if "inductance" in self.obs_special:
                self.obs_special["inductance"][i] = result.inductance[bi]
            self._store_dop_cap(i, result, bi)
            n_i = int(result.num_rows[bi])
            self.obs_fit_attr[i] = {
                "batched": True, "ragged": True, "x_raw": result.x_raw[bi][:ns + w_i],
                "scale": result.scale[bi], "weights": result.weights[bi][:n_i],
                "rho": result.rho[bi], "s_vectors": result.s_vectors[bi][:, :ns + w_i],
                "chrono_data": chronos[bi], "eis_data": eiss[bi],
                "converged": bool(result.converged[bi]), "n_iter": int(result.n_iter[bi]),
            }
            self.obs_rss[i] = rss[bi]
            self.obs_llh[i] = llh[bi]
            self.obs_fit_status[i] = True

    # ------------------------------------------------------------------
    # The (P, q) rebuild and the fits as DRTs (:933-1133, :1220-1354)
    # ------------------------------------------------------------------
    def get_fit(self, obs_index):
        """A DRT holding one observation's fit, its (P, q) in
        ``fit_parameters["p_matrix"]`` / ``["q_vector"]`` (:933)."""
        return self.get_fits_batched([obs_index])[obs_index]

    def _resolve_batch_fitter(self, obs_index, attr):
        """The shared-grid fitter of a uniform-batched observation: the
        registered one if it was built on this observation's grids, else one
        built from them in float64 (:946)."""
        fitter = getattr(self, "_batch_fitters", {}).get(attr.get("fitter_key")) \
            or getattr(self, "_batch_fitter", None)
        if fitter is not None and not self._fitter_matches_obs(fitter, obs_index, attr):
            fitter = None
        if fitter is None:
            chrono_data, eis_data = self.get_obs_data(obs_index)
            if attr.get("fitter_key") == "hybrid":
                fitter = self._hybrid_fitter(chrono_data[0], chrono_data[1], eis_data[0],
                                             dtype=torch.float64)
            else:
                fitter = self._eis_fitter(eis_data[0], dtype=torch.float64)
        return fitter

    def _uniform_group_key(self, obs_index):
        """The rebuild group of a fitted uniform-batched observation (its
        fitter kind and measurement grids), or None (:975)."""
        if not self.obs_fit_status[obs_index]:
            return None
        attr = self.obs_fit_attr[obs_index]
        if not (isinstance(attr, dict) and attr.get("batched")) or attr.get("ragged") \
                or attr.get("pfrt"):
            return None
        return attr.get("fitter_key"), self._obs_grid_sig(obs_index)

    def _obs_grid_sig(self, obs_index):
        chrono_data, eis_data = self.get_obs_data(obs_index)
        parts = []
        if chrono_data is not None and chrono_data[0] is not None:
            parts.append(np.asarray(chrono_data[0], dtype=float).tobytes())
            parts.append(np.asarray(chrono_data[1], dtype=float).tobytes())
        if eis_data is not None and eis_data[0] is not None:
            parts.append(np.asarray(eis_data[0], dtype=float).tobytes())
        return tuple(parts)

    def _fitter_matches_obs(self, fitter, obs_index, attr):
        """Whether a registered shared-grid fitter was built on this
        observation's grids (:1004)."""
        is_hybrid = attr.get("fitter_key") == "hybrid"
        if isinstance(fitter, BatchedHybridFitter) != is_hybrid:
            return False
        chrono_data, eis_data = self.get_obs_data(obs_index)
        if eis_data is None or eis_data[0] is None:
            return False
        freq = np.asarray(eis_data[0], dtype=float)
        if len(freq) != len(fitter.frequencies) or not np.allclose(freq, fitter.frequencies):
            return False
        if is_hybrid:
            times, i_sig = (np.asarray(a, dtype=float) for a in chrono_data[:2])
            return (len(times) == len(fitter.times) and np.allclose(times, fitter.times)
                    and np.allclose(i_sig, fitter.i_signal))
        return True

    @staticmethod
    def _uniform_attr_rzv(attr):
        if attr.get("rzv") is not None:
            return np.asarray(attr["rzv"])
        return np.concatenate([attr["z"].real, attr["z"].imag]) / attr["scale"]

    def _uniform_pq(self, fitter, attrs):
        """(P (B, N, N), q (B, N)) of uniform-batched observations of one
        fitter, rebuilt in one ``posterior_pq`` in float64 on the fitter's
        device (:1036); tensors there."""
        state = SimpleNamespace(**{k: np.stack([np.asarray(a[k], dtype=float) for a in attrs])
                                   for k in ("x_raw", "rho", "s_vectors", "weights")})
        rzv = np.stack([self._uniform_attr_rzv(a) for a in attrs])
        return fitter.posterior_pq(rzv, state)

    def _get_ragged_fitter(self):
        """The ragged fitter whose protocol cache re-prepares stored ragged
        observations: the one of this map's last ragged fit, or a float64 one (:1220)."""
        fitter = getattr(self, "_ragged_fitter", None)
        if fitter is None:
            fitter = self._ragged_fitter = BatchedRaggedFitter(self.tau_supergrid,
                                                               **self._ragged_fitter_kw())
        return fitter

    def _ragged_pq_batched(self, attrs):
        """(systems, [P_i], [q_i]) of ragged-batched observations, one
        ``calculate_pq`` per protocol in float64 on the fitter's device, P
        and q copied to the host once per protocol
        (``BatchedRaggedFitter.posterior``, :1238)."""
        return self._get_ragged_fitter().posterior(
            [(a["chrono_data"], a["eis_data"]) for a in attrs],
            *([a[k] for a in attrs] for k in ("x_raw", "rho", "s_vectors", "weights")))

    def _rebuild(self, obs_index):
        """{i: (P_i, q_i, source)} for fitted batched observations (the JAX
        package's ``_rebuild_batched_fit`` and ``_rebuild_ragged_fit``, and
        the grouping of its ``get_fits_batched``): P and q host float64,
        rebuilt on the device one batch per fitter or protocol group and
        copied to the host once per group; a serial fit's as it stored
        them. ``source`` is ("uniform", fitter, attr), ("ragged", system,
        attr) or ("serial", None, attr). An unfitted or failed observation
        raises ValueError."""
        groups, ragged, out = {}, [], {}
        for i in np.atleast_1d(obs_index):
            i = int(i)
            if not self.obs_fit_status[i]:
                raise ValueError(f"Observation {i} has not been fitted")
            attr = self.obs_fit_attr[i]
            if not attr.get("batched"):
                fp = attr["fit_parameters"]
                out[i] = (np.asarray(fp["p_matrix"]), np.asarray(fp["q_vector"]),
                          ("serial", None, attr))
                continue
            if attr.get("pfrt"):
                raise _unported("rebuilding a PFRT fit", 9)
            key = self._uniform_group_key(i)
            if key is None:
                ragged.append(i)
            else:
                groups.setdefault(key, []).append(i)
        for idx in groups.values():
            attrs = [self.obs_fit_attr[i] for i in idx]
            fitter = self._resolve_batch_fitter(idx[0], attrs[0])
            p, q = (t.cpu().numpy() for t in self._uniform_pq(fitter, attrs))
            for bi, i in enumerate(idx):
                out[i] = (p[bi], q[bi], ("uniform", fitter, attrs[bi]))
        if ragged:
            attrs = [self.obs_fit_attr[i] for i in ragged]
            systems, p_host, q_host = self._ragged_pq_batched(attrs)
            for k, i in enumerate(ragged):
                out[i] = (p_host[k], q_host[k], ("ragged", systems[k], attrs[k]))
        return out

    def _fit_scales(self, obs_index, source):
        """(special_qp_params, {response_signal_scale, scaled_response_offset,
        v_baseline_scale}, inductance_scale) of one stored fit."""
        kind, src, attr = source
        if kind == "serial":
            scales = {k: attr[k] for k in ("response_signal_scale", "scaled_response_offset",
                                           "v_baseline_scale")} \
                if "v_baseline" in attr["special_qp_params"] else {}
            return attr["special_qp_params"], scales, attr["inductance_scale"]
        if kind == "ragged":
            return (src["special_qp_params"],
                    {k: src[k] for k in ("response_signal_scale", "v_baseline_scale")}
                    | {"scaled_response_offset": src["scaled_response_offset"] or 0.0},
                    src["inductance_scale"])
        scales = {}
        if isinstance(src, BatchedHybridFitter):
            chrono_data, _ = self.get_obs_data(obs_index)
            scale = np.atleast_1d(float(attr["scale"]))
            scales = {"response_signal_scale": float(src.input_signal_scale * scale[0]),
                      "scaled_response_offset":
                          float(src.response_offsets(np.asarray(chrono_data[2])[None], scale)[0]),
                      "v_baseline_scale": src.v_baseline_scale}
        return src.special_qp_params, scales, src.inductance_scale

    def _make_drt(self, obs_index, p, q, source):
        """A DRT carrying one observation's fit and (P, q): the JAX package's
        ``_make_uniform_drt`` (:1070) and ``_make_ragged_drt`` (:1327)."""
        kind, src, attr = source
        if kind == "serial":
            # the JAX package builds DRT(interpolate_integrals=False) and then
            # sets integrate_method="interp" (:941-944): the port's default
            return DRT(device=self.device).set_attributes(deepcopy(attr))
        special, scales, inductance_scale = self._fit_scales(obs_index, source)
        if kind == "uniform":
            drt = self._fitter_template(src, isinstance(src, BatchedHybridFitter))
        else:
            drt = self._special_drt(self.tau_basis_type)
            drt.basis_tau = src["basis_tau"]
            drt.tau_epsilon = self.tau_epsilon
            drt.special_qp_params = special
            drt.inductance_scale = inductance_scale
            drt.capacitance_scale = src["capacitance_scale"]
            drt.dop_scale_vector = src["dop_scale_vector"]
            drt.input_signal_scale = src["input_signal_scale"]
        drt.coefficient_scale = attr["scale"]
        drt.impedance_scale = attr["scale"]
        drt.response_signal_scale = scales.get("response_signal_scale")
        drt.scaled_response_offset = scales.get("scaled_response_offset", 0.0)
        drt.v_baseline_scale = scales.get("v_baseline_scale")
        drt.fit_parameters = drt.extract_qphb_parameters(np.asarray(attr["x_raw"]))
        drt.fit_parameters["vz_offset_eps"] = self.fit_kw.get("vz_offset_eps", 1)
        drt.fit_parameters["p_matrix"] = np.asarray(p)
        drt.fit_parameters["q_vector"] = np.asarray(q)
        return drt

    def get_fits_batched(self, obs_index):
        """{i: DRT} for many observations, every batched fit's (P, q) rebuilt
        on the device in one batch per fitter or protocol group, every serial
        fit rebuilt from its stored attributes (:1097)."""
        return {i: self._make_drt(i, p, q, src) for i, (p, q, src) in
                self._rebuild(obs_index).items()}

    # ------------------------------------------------------------------
    # The group resolve (:1359-1585)
    # ------------------------------------------------------------------
    def get_group_index(self, group_id):
        return np.where(np.array([g == group_id for g in self.obs_group_id]))[0]

    def unique_group_ids(self):
        seen = []
        for g in self.obs_group_id:
            if g not in seen:
                seen.append(g)
        return seen

    def fitted_obs_index(self):
        return np.where(self.obs_fit_status & ~self.obs_ignore_flag)[0]

    def _sorted_group(self, group_id, psi_sort_dims=None, psi_distance_dims=None):
        """The group's fitted, not ignored observations, sorted by psi."""
        obs_index = self.get_group_index(group_id)
        obs_index = obs_index[self.obs_fit_status[obs_index] & ~self.obs_ignore_flag[obs_index]]
        dims = psi_sort_dims or psi_distance_dims
        if dims is not None:
            sort_vals = [self.obs_psi[obs_index, self.psi_dim_names.index(d)] for d in dims][::-1]
            obs_index = obs_index[np.lexsort(sort_vals)]
        return obs_index

    def _block_inputs(self, obs_index):
        """The rebuilt (P, q) of ``obs_index`` and the stored fit values
        ``prepare_group_blocks`` takes, per observation, in order."""
        rebuilt = self._rebuild(obs_index)
        cols = {k: [] for k in ("p", "q", "scale", "r_inf", "tau", "special", "params", "scales",
                                "inductance", "dop_scale", "cap_scale", "x_dop")}
        for i in obs_index:
            p, q, source = rebuilt[int(i)]
            special, scales, ind = self._fit_scales(int(i), source)
            attr = source[2]
            if source[0] == "serial":
                scale, params = float(attr["coefficient_scale"]), attr["fit_parameters"]
            else:
                scale = float(attr["scale"])
                params = data_offset_parameters(
                    np.asarray(attr["x_raw"], dtype=float), special,
                    scales.get("v_baseline_scale"), scales.get("scaled_response_offset"),
                    scales.get("response_signal_scale")) if scales else {}
            dsv, cap, x_dop = self._dop_cap_inputs(source, special, scale)
            for k, v in (("p", p), ("q", q), ("scale", scale), ("tau", self.obs_tau_indices[i]),
                         ("r_inf", self.obs_special["R_inf"][i] / scale
                          if "R_inf" in self.obs_special else 0.0),
                         ("special", special), ("params", params), ("scales", scales),
                         ("inductance", ind), ("dop_scale", dsv), ("cap_scale", cap),
                         ("x_dop", x_dop)):
                cols[k].append(v)
        return cols

    @staticmethod
    def _dop_cap_inputs(source, special, scale):
        """(dop_scale_vector, capacitance_scale, x_dop / (scale times the
        DOP scale vector)) of one stored fit, as the JAX resolve reads them
        off its DRT (resolve.py:169-172, :573-576); None where absent."""
        kind, src, attr = source
        if kind == "serial":
            dsv, cap = attr.get("dop_scale_vector"), attr.get("capacitance_scale")
            x_dop = attr["fit_parameters"].get("x_dop")
        else:
            get = src.get if kind == "ragged" else lambda k: getattr(src, k)
            dsv, cap = get("dop_scale_vector"), get("capacitance_scale")
            x_dop = None
            if dsv is not None:
                sl = special_slice(special, "x_dop")
                x_dop = np.asarray(attr["x_raw"], dtype=float)[sl] * (dsv * scale)
        if dsv is None or x_dop is None:
            return dsv, cap, None
        return dsv, cap, np.asarray(x_dop) / (scale * np.asarray(dsv))

    def _blocks(self, cols, sel, **kw):
        """prepare_group_blocks of the observations ``sel`` of ``cols``."""
        pick = lambda k: [cols[k][j] for j in sel]
        x_dop = pick("x_dop")
        return resolve_mod.prepare_group_blocks(
            pick("p"), pick("q"), pick("scale"), pick("r_inf"), pick("tau"), pick("special"),
            self.fit_kw.get("nonneg", True), fit_parameters=pick("params"),
            scales=pick("scales"),
            x_dop_scaled=None if any(v is None for v in x_dop) else x_dop, **kw)

    def _write_resolved(self, x, cols, sel, rows, special_dict, mti):
        """One solution x (len(sel), nc) of the observations ``sel`` of
        ``cols`` (``rows`` of the map) into ``obs_x_resolved`` (its tau span
        ``mti``; the other columns keep what they hold) and
        ``obs_special_resolved``."""
        pick = lambda k: [cols[k][j] for j in sel]
        x_drt, x_sp = resolve_mod.unpack_resolved_x(
            np.reshape(x, (len(sel), -1)), np.asarray(cols["scale"])[sel], special_dict,
            np.asarray(cols["inductance"], dtype=float)[sel],
            dop_scale_vector=pick("dop_scale") if "x_dop" in special_dict else None,
            capacitance_scale=pick("cap_scale") if "C_inv" in special_dict else None)
        self.obs_x_resolved[rows[:, None], np.arange(mti[0], mti[1])[None, :]] = x_drt
        for key, val in x_sp.items():
            if key not in self.obs_special_resolved:
                self.obs_special_resolved[key] = np.zeros(
                    (self.num_obs, *self.special_param_shape(key)))
            self.obs_special_resolved[key][rows] = val

    def _resolve_windows(self, cols, obs_index, windows, block_kw, dtype, batched,
                         on_window=None):
        """Each window (positions into ``cols`` and ``obs_index``) assembled
        into its block QP on the host, all of them solved in one
        ``solve_resolve_batch`` (``batched``) or one dense QP after another
        (``solve_dense_windows``), on this map's device, and written back in
        window order, ``on_window(w)`` called after window w's write.
        Returns the solver's info with the assembly and solve walls."""
        t0 = time.time()
        systems, metas = [], []
        for pos in windows:
            *system, meta = self._blocks(cols, pos, **block_kw)
            systems.append(tuple(system))
            metas.append(meta)
        t1 = time.time()
        if batched:
            xs, info = resolve_mod.solve_resolve_batch(systems, dtype=dtype, device=self.device,
                                                       return_info=True)
        else:
            xs, info = solve_dense_windows(systems, dtype=dtype, device=self.device)
        info.update(assembly_s=t1 - t0, solve_s=time.time() - t1)
        for w, (pos, x, (special_dict, mti, _, _)) in enumerate(zip(windows, xs, metas)):
            self._write_resolved(np.asarray(x), cols, pos, obs_index[pos], special_dict, mti)
            if on_window is not None:
                on_window(w)
        return info

    def _distance_order(self, obs_index, psi_distance_dims):
        if psi_distance_dims is None:
            return np.arange(len(obs_index))
        return np.lexsort([self.obs_psi[obs_index, self.psi_dim_names.index(d)]
                           for d in psi_distance_dims][::-1])

    def resolve_observations(self, obs_index, psi_sort_dims=None, psi_distance_dims=None,
                             truncate=False, sigma=1, lambda_psi=1, tau_filter_sigma=0,
                             special_filter_sigma=0, dtype=None):
        """Jointly re-optimize the fitted, not ignored observations of
        ``obs_index`` (sorted by ``psi_sort_dims``, else
        ``psi_distance_dims``) as one dense QP (:1362), solved in ``dtype``
        (float64 by default) on this map's device; a lone observation keeps
        its fit."""
        obs_index = np.asarray(obs_index)
        obs_index = obs_index[self.obs_fit_status[obs_index] & ~self.obs_ignore_flag[obs_index]]
        sort_dims = psi_sort_dims if psi_sort_dims is not None else psi_distance_dims
        obs_index = obs_index[self._distance_order(obs_index, sort_dims)]
        if len(obs_index) == 0:
            warnings.warn("No valid observations in resolution group")
            return
        if len(obs_index) == 1:
            self._keep_fit(obs_index)
            return
        self._resolve_windows(self._block_inputs(obs_index), obs_index,
                              [np.arange(len(obs_index))],
                              dict(truncate=truncate, sigma=sigma, lambda_psi=lambda_psi,
                                   tau_filter_sigma=tau_filter_sigma,
                                   special_filter_sigma=special_filter_sigma), dtype,
                              batched=False)
        self.obs_resolve_status[obs_index] = True

    def _keep_fit(self, obs_index):
        self.obs_x_resolved[obs_index] = self.obs_x[obs_index]
        for k, v in (self.obs_special or {}).items():
            self.obs_special_resolved[k][obs_index] = v[obs_index]
        self.obs_resolve_status[obs_index] = True

    def resolve_group(self, group_id, batch_size=7, overlap=2, psi_sort_dims=None,
                      psi_distance_dims=None, truncate=False, sigma=1, lambda_psi=1,
                      tau_filter_sigma=0, special_filter_sigma=0, batched=False, mesh=None,
                      coupled=False, dtype=None):
        """Joint re-optimization of a group (:1408-1585): its observations
        sorted by psi, their (P, q) rebuilt once (``get_fits_batched``'s
        rebuild: batched fits on the device, serial fits as stored), the
        hybrid fits' v_baseline and vz_offset marginalized, every block
        resized to the union of the tau windows (the intersection with
        ``truncate``).

        By default (the reference's) the overlapping windows of
        ``batch_size`` are solved one after another, each as one dense QP
        (``resolve_observations``' form, each window re-sorted by
        ``psi_distance_dims`` where given), and averaged with the
        reference's margin weights; ``batched=True`` solves every window's
        blocks in one ``solve_resolve_batch``, matrix-free;
        ``coupled=True`` solves the whole group as one box QP
        (``resolve.solve_coupled_group``) and warns when its KKT residual is
        above the JAX package's tolerance. A failure of the batched solve
        fails the call. ``dtype`` is the solve's (float64 by default), on
        this map's device. ``resolve_info`` holds the solver's counts (the
        windows' IP iterations in ``n_iter``) and the walls of the rebuild
        (``rebuild_s``), the host assembly (``assembly_s``) and the solve
        (``solve_s``)."""
        if mesh is not None:
            raise _unported("mesh: multi-GPU sharding", 10)
        obs_index = self._sorted_group(group_id, psi_sort_dims, psi_distance_dims)
        self.obs_x_resolved[obs_index] = 0
        num_obs = len(obs_index)
        if num_obs == 0:
            return
        if num_obs == 1:
            self._keep_fit(obs_index)
            return
        block_kw = dict(truncate=truncate, sigma=sigma, lambda_psi=lambda_psi,
                        tau_filter_sigma=tau_filter_sigma,
                        special_filter_sigma=special_filter_sigma)
        t0 = time.time()
        cols = self._block_inputs(obs_index)
        times = {"rebuild_s": time.time() - t0}

        if coupled:
            t0 = time.time()
            p_stack, q_stack, lb, my, cmat, (special_dict, mti, _, _) = \
                self._blocks(cols, range(num_obs), **block_kw)
            times["assembly_s"] = time.time() - t0
            t0 = time.time()
            x, n_iter, kkt, counts = resolve_mod.solve_coupled_group(
                p_stack, q_stack, lb, my, cmat, dtype=dtype, device=self.device, return_info=True)
            times["solve_s"] = time.time() - t0
            kkt_tol = (1e-3 if dtype == torch.float32 else 1e-6) \
                * max(1.0, float(np.abs(q_stack).max()))
            self.resolve_info = {"coupled": True, "n_iter": n_iter, "kkt_residual": kkt,
                                 "kkt_tol": kkt_tol, **counts, **times}
            if not np.isfinite(kkt) or kkt > kkt_tol:
                warnings.warn(
                    f"Coupled group resolve did not fully converge (KKT residual {kkt:.3g} > "
                    f"{kkt_tol:.3g} after {n_iter} IP iterations); the stored resolved "
                    f"distributions may be inaccurate. Consider dtype=float64 or the windowed "
                    f"resolve (coupled=False).")
            self._write_resolved(x, cols, np.arange(num_obs), obs_index, special_dict, mti)
            self.obs_resolve_status[obs_index] = True
            return

        windows = resolve_windows(num_obs, batch_size, overlap)
        batch_size = windows[0][1] - windows[0][0]
        n_win = len(windows)
        x_batch = np.zeros((n_win, num_obs, self.obs_x_resolved.shape[1]))
        x_special = {k: np.zeros((n_win, num_obs, *self.special_param_shape(k)))
                     for k in (self.obs_special_resolved or {})}
        margins = np.full((n_win, num_obs), -1.0)

        def collect(w):
            """Window w's resolved rows into the averaging stacks."""
            start, end = windows[w]
            bidx = obs_index[start:end]
            x_batch[w, start:end] = self.obs_x_resolved[bidx]
            for key in self.obs_special_resolved:
                if key not in x_special:
                    x_special[key] = np.zeros((n_win, num_obs, *self.special_param_shape(key)))
                x_special[key][w, start:end] = self.obs_special_resolved[key][bidx]
            margins[w, start:end] = np.minimum(np.arange(batch_size),
                                               np.arange(batch_size)[::-1])

        # the reference's dense windows are each re-sorted by psi_distance_dims
        # (its resolve_observations); its batched windows keep the group's order
        positions = [np.arange(start, end) for start, end in windows]
        if not batched:
            positions = [pos[self._distance_order(obs_index[pos], psi_distance_dims)]
                         for pos in positions]
        info = self._resolve_windows(cols, obs_index, positions, block_kw, dtype, batched,
                                     on_window=collect)
        self.resolve_info = {"coupled": False, "windows": n_win, **info, **times}

        if overlap > 0:
            weights = margins + 0.1
            weights[weights < 0] = 0
            x_w = np.moveaxis(np.tile(weights, (x_batch.shape[-1], 1, 1)), 0, -1)
            self.obs_x_resolved[obs_index] = np.average(x_batch, axis=0, weights=x_w)
            for key, val in x_special.items():
                w_k = np.moveaxis(np.tile(weights, (val.shape[-1], 1, 1)), 0, -1) \
                    if val.ndim > 2 else weights
                self.obs_special_resolved[key][obs_index] = np.average(val, axis=0, weights=w_k)
        self.obs_resolve_status[obs_index] = True

    def group_objective(self, group_id, psi_sort_dims=None, **block_kw):
        """The coupled group objective 1/2 x.Hx + q.x (host float64, solver
        units) of a group at its stored resolved solution
        (``obs_x_resolved``, ``obs_special_resolved``) on the group's union
        window, EIS and hybrid fits alike: the coupled resolve minimizes it,
        so it is no higher there than at the windowed resolve. ``block_kw``
        are the resolve's block settings (``sigma``, ``lambda_psi``, ...)."""
        obs_index = self._sorted_group(group_id, psi_sort_dims)
        cols = self._block_inputs(obs_index)
        p, q, _, my, cmat, (special_dict, mti, _, _) = self._blocks(
            cols, range(len(obs_index)), **block_kw)
        scale = np.asarray(cols["scale"])
        x = np.zeros(q.shape)
        x[:, len(special_dict):] = self.obs_x_resolved[obs_index, mti[0]:mti[1]] \
            / scale[:, None]
        for key, info in special_dict.items():
            unit = np.asarray(cols["inductance"], dtype=float) if key == "inductance" else 1.0
            x[:, info["index"]] = self.obs_special_resolved[key][obs_index] / (scale * unit)
        return block_objective(p, q, my, cmat, x)


    # ------------------------------------------------------------------
    # Prediction (:1590-1683)
    # ------------------------------------------------------------------
    def _resolved_source(self, resolved):
        return resolved and self.obs_resolve_status.any()

    def predict_x(self, psi=None, obs_index=None, resolved=True, factor_index=None):
        """DRT coefficients on the supergrid at the requested indices, or at
        the observations nearest in psi (:1590); the resolved ones where a
        resolve has run and ``resolved``. ``factor_index`` selects a PFRT
        level, and this map holds no PFRT fits (item 9)."""
        x_source = self.obs_x_resolved if (self._resolved_source(resolved)
                                           and self.fit_type == "drt") else self.obs_x
        if obs_index is not None:
            return x_source[np.asarray(obs_index)]
        if psi is None:
            return x_source
        return x_source[self.get_psi_index(psi)]

    def predict_drt(self, psi=None, obs_index=None, tau=None, order=0, resolved=True):
        """gamma(ln tau), or its order-th derivative in ln tau, for the
        requested observations (:1610)."""
        if tau is None:
            tau = self.tau_supergrid
        x = self.predict_x(psi, obs_index, resolved)
        em = basis_mod.func_eval_matrix_host(np.log(self.tau_supergrid), np.log(np.asarray(tau)),
                                             self.tau_basis_type, self.tau_epsilon, order)
        return x @ em.T

    def predict_r_p(self, psi=None, obs_index=None, resolved=True):
        """Polarization resistance: sum |x| times the basis area (:1621)."""
        x = self.predict_x(psi, obs_index, resolved)
        return np.sum(np.abs(x), axis=-1) * self.tau_basis_area

    def predict_special(self, key, psi=None, obs_index=None, resolved=True):
        """A special parameter (R_inf, inductance, ...) of the requested
        observations (:1627)."""
        source = self.obs_special_resolved if self._resolved_source(resolved) \
            else self.obs_special
        vals = source[key]
        if obs_index is not None:
            return vals[np.asarray(obs_index)]
        if psi is None:
            return vals
        return vals[self.get_psi_index(psi)]

    # ------------------------------------------------------------------
    # The fits' posterior (:1639-1680, :1874-1980)
    # ------------------------------------------------------------------
    def _param_covs(self, fits, obs_index):
        """{i: parameter covariance (physical units, host numpy)} of the
        fitted DRTs ``fits``: their P inverted in float64 on this map's
        device, one batched ``invert_psd`` per size of P."""
        by_n = {}
        for i in obs_index:
            by_n.setdefault(fits[i]._p_matrix().shape[0], []).append(i)
        out = {}
        for idx in by_n.values():
            p = torch.as_tensor(np.stack([fits[i]._p_matrix() for i in idx]),
                                dtype=torch.float64, device=self.device)
            inv = mat1d.invert_psd(p).cpu().numpy()
            for k, i in enumerate(idx):
                out[i] = fits[i].scale_param_cov(inv[k])
        return out

    def _fitted_covs(self, obs_index):
        """(fits, covs) of the fitted observations among ``obs_index``."""
        fitted = sorted({int(i) for i in np.atleast_1d(obs_index) if self.obs_fit_status[i]})
        if not fitted:
            return {}, {}
        fits = self.get_fits_batched(fitted)
        return fits, self._param_covs(fits, fitted)

    def predict_param_cov(self, obs_index, factor_index=None):
        """Each observation's posterior parameter covariance (None where
        unfitted) (:1639). ``factor_index`` selects a PFRT level, and this
        map holds no PFRT fits (item 9)."""
        _, covs = self._fitted_covs(obs_index)
        return [covs.get(int(i)) for i in np.atleast_1d(obs_index)]

    def predict_x_cov(self, obs_index, factor_index=None):
        """The DRT coefficients' covariance on the supergrid, (n, T, T), NaN
        where unfitted (:1661)."""
        obs_index = np.atleast_1d(obs_index)
        fits, covs = self._fitted_covs(obs_index)
        n_tau = len(self.tau_supergrid)
        x_cov = np.zeros((len(obs_index), n_tau, n_tau))
        for k, i in enumerate(obs_index):
            cov = covs.get(int(i))
            if cov is None:
                x_cov[k] = np.nan
                continue
            li, ri = self.obs_tau_indices[i]
            ns = fits[int(i)].get_qp_mat_offset()
            x_cov[k, li:ri, li:ri] = cov[ns:, ns:]
        return x_cov

    def _drt_covs(self, obs_index, tau, orders, extend_var):
        """{order: [distribution covariance on ``tau``]} of each observation
        (NaN where unfitted), one covariance of the parameters for all
        ``orders``."""
        fits, covs = self._fitted_covs(obs_index)
        nan = np.full((len(tau), len(tau)), np.nan)
        return {order: [fits[int(i)].distribution_cov(covs[int(i)], tau, order=order,
                                                      extend_var=extend_var)
                        if int(i) in covs else nan for i in np.atleast_1d(obs_index)]
                for order in orders}

    def predict_drt_cov(self, obs_index, tau=None, order=0, factor_index=None, extend_var=True):
        """Each observation's distribution covariance on ``tau`` (:1874)."""
        if tau is None:
            tau = self.get_tau_eval(10)
        return self._drt_covs(obs_index, tau, (order,), extend_var)[order]

    def predict_drt_var(self, obs_index, tau=None, order=0, factor_index=None, extend_var=True):
        """The distribution variance on ``tau``, (n, len(tau)) (:1896)."""
        covs = self.predict_drt_cov(obs_index, tau, order, factor_index, extend_var)
        return np.array([np.diag(c) for c in covs])

    def predict_x_var(self, obs_index, factor_index=None):
        """The DRT coefficients' variance on the supergrid (:1901)."""
        return np.array([np.diag(c) for c in self.predict_x_cov(obs_index, factor_index)])

    def _prob_inputs(self, psi, obs_index, tau, orders, extend_var):
        if tau is None:
            tau = self.get_tau_eval(10)
        if obs_index is None:
            obs_index = self.get_psi_index(psi) if psi is not None else self.fitted_obs_index()
        mus = [self.predict_drt(obs_index=obs_index, tau=tau, order=k) for k in orders]
        covs = self._drt_covs(obs_index, tau, orders, extend_var)
        return mus, [np.array([np.diag(c) for c in covs[k]]) for k in orders]

    def predict_curv_prob(self, psi=None, obs_index=None, tau=None, factor_index=None,
                          extend_var=True):
        """P(negative curvature and positive height) over (observation, tau)
        (:1935)."""
        (f, fxx), (f_var, fxx_var) = self._prob_inputs(psi, obs_index, tau, (0, 2), extend_var)
        p_curv = 1 - ndtr(fxx / np.sqrt(np.maximum(fxx_var, 1e-30)))
        p_f = 1 - ndtr(-f / np.sqrt(np.maximum(f_var, 1e-30)))
        return p_curv * p_f

    def predict_peak_prob(self, psi=None, obs_index=None, tau=None, factor_index=None,
                          extend_var=True):
        """Peak probability over (observation, tau) from the surface peak and
        trough model (:1958)."""
        mus, var = self._prob_inputs(psi, obs_index, tau, (0, 1, 2), extend_var)
        pp_ = surface.peak_prob(*mus, f_var=var[0], fx_var=var[1], fxx_var=var[2])
        tp_ = surface.trough_prob(*mus, f_var=var[0], fx_var=var[1], fxx_var=var[2])
        return pp_ * (1 - tp_)

    def predict_dop(self, psi=None, obs_index=None, nu=None, normalize=True, resolved=True):
        """The DOP over nu of the requested observations (:1906): their
        x_dop on the nu basis, with ``normalize`` divided by the phasor
        scale over the supergrid."""
        if not self.fit_dop:
            raise ValueError("DOP was not fitted")
        if nu is None:
            nu = self.get_nu_eval()
        x_dop = self.predict_special("x_dop", psi=psi, obs_index=obs_index, resolved=resolved)
        basis_nu = default_basis_nu(self.fixed_basis_nu)
        # nu_epsilon defaults to None in the configuration; the fitted DRT
        # resolves it, so fall back to that, then to the spacing default
        nu_epsilon = self.nu_epsilon
        if nu_epsilon is None:
            nu_epsilon = getattr(self.drt1d, "nu_epsilon", None)
        if nu_epsilon is None:
            nu_epsilon = 1 / np.abs(np.median(np.diff(np.sort(basis_nu))))
        em = basis_mod.func_eval_matrix_host(basis_nu, np.asarray(nu), self.nu_basis_type,
                                             nu_epsilon, 0)
        dop = x_dop @ em.T
        if normalize:
            dop = dop / phasance.phasor_scale_vector(np.asarray(nu), self.tau_supergrid)
        return dop

    # ------------------------------------------------------------------
    # Convenience accessors (:1688-1794)
    # ------------------------------------------------------------------
    def get_tau_eval(self, ppd=10):
        """Evaluation grid over the tau supergrid, ``ppd`` points a decade."""
        log_min = np.log10(self.tau_supergrid[0])
        log_max = np.log10(self.tau_supergrid[-1])
        return np.logspace(log_min, log_max, int((log_max - log_min) * ppd) + 1)

    def get_nu_eval(self, n=201):
        return np.linspace(-1, 1, n)

    @property
    def tau_basis_area(self):
        return basis_mod.get_basis_func_area(self.tau_basis_type, self.tau_epsilon)

    def get_psi_index(self, psi):
        """Indices of the nearest stored observations to the given psi rows."""
        psi = np.atleast_2d(psi)
        return np.array([int(np.argmin(np.sum((self.obs_psi - p) ** 2, axis=1)))
                         for p in psi])

    @property
    def obs_dtype(self):
        """Per-observation data type: 'eis', 'chrono' or 'hybrid'."""
        out = []
        for i in range(self.num_obs):
            chrono_data, eis_data = self.get_obs_data(i)
            has_c = chrono_data is not None and chrono_data[0] is not None
            has_e = eis_data is not None and eis_data[0] is not None
            out.append("hybrid" if (has_c and has_e) else ("eis" if has_e else "chrono"))
        return out

    def filter_psi(self, dim_eq=None, dim_gt=None, dim_lt=None, return_index=True,
                   exclude_flagged=False):
        """Select observations by psi conditions: dim_eq/gt/lt map a
        dimension name to a value."""
        conditions = [np.ones(self.num_obs, dtype=bool)]
        for cond_dict, op in ((dim_eq, np.equal), (dim_gt, np.greater), (dim_lt, np.less)):
            for name, val in (cond_dict or {}).items():
                conditions.append(op(self.obs_psi[:, self.psi_dim_names.index(name)], val))
        if exclude_flagged:
            conditions.append(~self.obs_ignore_flag)
        mask = np.logical_and.reduce(conditions)
        return np.where(mask)[0] if return_index else mask

    def obs_psi_df(self):
        """psi, group id and flags as a pandas DataFrame (pandas imported
        here, as the JAX class does)."""
        import pandas as pd
        names = self.psi_dim_names or [f"psi{i}" for i in range(self.obs_psi.shape[1])]
        df = pd.DataFrame(self.obs_psi, columns=names)
        df["group_id"] = self.obs_group_id
        df["fitted"] = self.obs_fit_status
        df["ignore"] = self.obs_ignore_flag
        return df

    def clear_fits(self):
        """Reset all fit results, keeping the observations."""
        self.obs_fit_status[:] = False
        self.obs_resolve_status[:] = False
        self.obs_x[:] = 0
        self.obs_drt_var[:] = 0
        self.obs_x_resolved[:] = 0
        self.obs_x_filt[:] = 0
        self.obs_fit_attr = [None] * self.num_obs
        self.obs_tau_indices = [None] * self.num_obs
        for d in (self.obs_special, self.obs_special_resolved, self.obs_special_filt):
            if d is not None:
                for k in d:
                    d[k][:] = 0

    def clear_obs(self):
        """Remove all observations and results, keeping the configuration
        the JAX class keeps (:1770), and the device."""
        self.__init__(tau_supergrid=self.tau_supergrid, psi_dim_names=self.psi_dim_names,
                      tau_basis_type=self.tau_basis_type, tau_epsilon=self.tau_epsilon,
                      step_model=self.step_model, chrono_mode=self.chrono_mode,
                      fit_inductance=self.fit_inductance, fit_ohmic=self.fit_ohmic,
                      fit_capacitance=self.fit_capacitance, fixed_basis_nu=self.fixed_basis_nu,
                      fit_dop=self.fit_dop, normalize_dop=self.normalize_dop,
                      nu_basis_type=self.nu_basis_type, nu_epsilon=self.nu_epsilon,
                      chrono_reader=self.chrono_reader, eis_reader=self.eis_reader,
                      fit_kw=self.fit_kw, fit_type=self.fit_type,
                      pfrt_factors=self.pfrt_factors, warn=self.warn,
                      print_progress=self.print_progress, device=self.device)

    def load_observations(self, psi_array, chrono_files=None, eis_files=None, group_ids=None,
                          fit=False):
        raise NotImplementedError("load_observations: the file readers (fileload) are not "
                                  "ported yet (ROADMAP, Host modules); pass the data as arrays "
                                  "to add_observations")

    # ------------------------------------------------------------------
    # Filtered maps and QC scores (:1799-1869)
    # ------------------------------------------------------------------
    def filter_observations(self, obs_index=None, psi_sort_dims=None, resolved=True,
                            sigma=(1, 1), store=True, **filter_kw):
        """Gaussian-filter the (psi-sorted) 2-D (obs, tau) map of the fitted,
        not ignored observations and their special parameters (:1799);
        returns (obs_index, x, special) and with ``store`` keeps them in
        ``obs_x_filt`` and ``obs_special_filt``."""
        if obs_index is None:
            obs_index = np.arange(self.num_obs)
        obs_index = np.asarray(obs_index)
        include = self.obs_fit_status[obs_index] & ~self.obs_ignore_flag[obs_index]
        obs_index = obs_index[include]
        if psi_sort_dims is not None:
            sort_vals = [self.obs_psi[obs_index, self.psi_dim_names.index(d)]
                         for d in psi_sort_dims][::-1]
            obs_index = obs_index[np.lexsort(sort_vals)]
        from_resolved = self._resolved_source(resolved)
        x_src = self.obs_x_resolved if from_resolved else self.obs_x
        x = ndimage.gaussian_filter(np.asarray(x_src[obs_index], dtype=float), sigma=sigma,
                                    **filter_kw)
        if store:
            self.obs_x_filt[obs_index] = x
        sp_src = self.obs_special_resolved if from_resolved else self.obs_special
        sp_out = {}
        for key, vals in (sp_src or {}).items():
            v = np.asarray(vals[obs_index], dtype=float)
            sig = sigma[0] if np.ndim(sigma) else sigma
            v_f = ndimage.gaussian_filter1d(v, sigma=sig, axis=0) if v.ndim > 0 else v
            sp_out[key] = v_f
            if store:
                self.obs_special_filt[key][obs_index] = v_f
        return obs_index, x, sp_out

    def filter_group(self, group_id, **kw):
        return self.filter_observations(self.get_group_index(group_id), **kw)

    def score_group_fit_badness(self, group_id, psi_sort_dims=None, median_size=(3, 3),
                                std_size=(5, 3)):
        """Per-observation fit badness: the rss of the group's fitted map
        against its median-filtered version (``nddata.flag_bad_obs``, :1832);
        stored in ``obs_fit_badness``."""
        obs_index = self.get_group_index(group_id)
        if psi_sort_dims is not None:
            sort_vals = [self.obs_psi[obs_index, self.psi_dim_names.index(d)]
                         for d in psi_sort_dims][::-1]
            obs_index = obs_index[np.lexsort(sort_vals)]
        x_array = np.asarray(self.obs_x[obs_index], dtype=float).copy()
        x_array[self.obs_ignore_flag[obs_index] | ~self.obs_fit_status[obs_index]] = np.nan
        x_filt = ndimage.median_filter(np.nan_to_num(x_array), size=median_size)
        _, rss_list = nddata.flag_bad_obs(x_array, x_filt, std_size=std_size, return_rss=True)
        x_rss = np.asarray(rss_list[0]).reshape(-1)
        self.obs_fit_badness[obs_index] = x_rss
        return obs_index, x_rss

    def score_group_data_badness(self, group_id, **kk_kw):
        raise _unported("score_group_data_badness: the Kramers-Kronig test (kk_test)", 9)

    # ------------------------------------------------------------------
    # Persistence (:1983-2069)
    # ------------------------------------------------------------------
    _persist_attrs = [
        "fit_type", "pfrt_factors",
        "tau_supergrid", "psi_dim_names", "tau_basis_type", "tau_epsilon",
        "fixed_basis_nu", "nu_basis_type", "nu_epsilon", "fit_dop", "fit_kw",
        "batch_fit_kw",
        "fit_ohmic", "fit_inductance", "fit_capacitance", "normalize_dop",
        "step_model", "chrono_mode",
        "obs_psi", "obs_data", "obs_group_id", "obs_data_badness", "obs_ignore_flag",
        "obs_x", "obs_drt_var", "obs_special", "obs_fit_status", "obs_fit_badness",
        "obs_tau_indices", "obs_llh", "obs_rss", "obs_resolve_status",
        "obs_x_resolved", "obs_special_resolved", "obs_x_filt", "obs_special_filt",
        "obs_fit_attr",
    ]

    @property
    def attribute_categories(self):
        """Persistable attributes by category: 'config', 'obs_data', 'fit'."""
        fit_keys = {"obs_fit_status", "obs_fit_attr", "obs_fit_badness", "obs_tau_indices",
                    "obs_x", "obs_special", "obs_drt_var", "obs_resolve_status",
                    "obs_x_resolved", "obs_special_resolved", "obs_x_filt", "obs_special_filt",
                    "obs_llh", "obs_rss"}
        obs_keys = {"obs_psi", "obs_data", "obs_group_id", "obs_ignore_flag",
                    "obs_data_badness"}
        return {
            "config": [k for k in self._persist_attrs if k not in fit_keys and k not in obs_keys],
            "obs_data": [k for k in self._persist_attrs if k in obs_keys],
            "fit": [k for k in self._persist_attrs if k in fit_keys],
        }

    def _category_attr_names(self, which):
        if which is None or which == "all":
            return list(self._persist_attrs)
        if isinstance(which, str):
            which = [which]
        cats = self.attribute_categories
        try:
            return sum([cats[c] for c in which], [])
        except KeyError:
            raise ValueError(f"Invalid attribute category; valid: {['all'] + list(cats.keys())}")

    def get_attributes(self, which=None):
        """The attributes of a category or list of categories ('config' |
        'obs_data' | 'fit' | 'all')."""
        return {k: getattr(self, k) for k in self._category_attr_names(which)}

    def set_attributes(self, att_dict):
        if att_dict.get("fit_type", self.fit_type) == "pfrt":
            raise _unported("a map of PFRT fits", 9)
        for k, v in att_dict.items():
            setattr(self, k, v)

    def save_attributes(self, which, dest=None):
        """Pickle attributes to ``dest`` (with one argument, all of them to
        that path), in the file format of the JAX class."""
        if dest is None:
            which, dest = None, which
        with open(dest, "wb") as f:
            pickle.dump(self.get_attributes(which), f)

    def load_attributes(self, source):
        """Set attributes from a pickle written by ``save_attributes``, this
        class's or the JAX class's (``load_pickle``)."""
        self.set_attributes(load_pickle(source))

    @classmethod
    def from_source(cls, source, device=None):
        """A map built from a ``save_attributes`` pickle (a path) or an
        attribute dict, on ``device`` (the card unless "cpu"); a map of PFRT
        fits raises, naming its item."""
        if not isinstance(source, dict):
            att_dict = load_pickle(source)
        else:
            att_dict = dict(source)
        config_keys = ["tau_supergrid", "psi_dim_names", "tau_basis_type", "tau_epsilon",
                       "fixed_basis_nu", "nu_epsilon", "nu_basis_type", "fit_dop", "fit_ohmic",
                       "fit_inductance", "fit_capacitance", "normalize_dop", "step_model",
                       "chrono_mode"]
        init_kw = {k: att_dict.pop(k) for k in config_keys if k in att_dict}
        drtmd = cls(**init_kw, device=device)
        drtmd.set_attributes(att_dict)
        return drtmd


# ---------------------------------------------------------------------------
# Reading the JAX class's files where JAX is absent
# ---------------------------------------------------------------------------
_JAX_MODULES = ("jax", "jaxlib", "hybdrt_tpu")


class _JaxQPHBConfig:
    """Unpickles the JAX package's QPHBConfig, a NamedTuple of the port's
    QPHBConfig fields in the same order, as the port's."""

    def __new__(cls, *args, **kw):
        return QPHBConfig(*args, **kw)


class _Foreign:
    """Stands in for any other object of JAX or the JAX package in a pickle,
    so that ``load_pickle`` can name where it lies."""
    qualname = None

    def __new__(cls, *args, **kw):
        return object.__new__(cls)

    def __init__(self, *args, **kw):
        pass

    def __setstate__(self, state):
        pass


def _jax_array(fun, args, arr_state, aval_state):
    """Unpickles a JAX array (``jax._src.array._reconstruct_array``: the
    numpy array it was copied from, then its device and type state) as that
    numpy array: a serial fit's "detail" attributes hold its history so."""
    np_value = fun(*args)
    np_value.__setstate__(arr_state)
    return np_value


class _MapUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_MODULES:
            if (module, name) == ("hybdrt_tpu.solver.qphb", "QPHBConfig"):
                return _JaxQPHBConfig
            if (module, name) == ("jax._src.array", "_reconstruct_array"):
                return _jax_array
            return type("Foreign", (_Foreign,), {"qualname": f"{module}.{name}"})
        return super().find_class(module, name)


def _foreign_paths(obj, path, out):
    if isinstance(obj, _Foreign) or (isinstance(obj, type) and issubclass(obj, _Foreign)):
        out.append((path, obj.qualname))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _foreign_paths(v, f"{path}[{k!r}]", out)
    elif isinstance(obj, (list, tuple)):
        for k, v in enumerate(obj):
            _foreign_paths(v, f"{path}[{k}]", out)
    return out


def load_pickle(source):
    """The attribute dict of a ``save_attributes`` pickle, this class's or
    the JAX class's, without importing JAX: the JAX package's QPHBConfig
    (which a serial fit stores in ``qphb_params["cfg"]``) is read as the
    port's, and a JAX array (a "detail" history's) as a numpy array; any
    other JAX object raises ValueError naming the attribute
    that holds it (ROADMAP Queue 3 item 15)."""
    with open(source, "rb") as f:
        att_dict = _MapUnpickler(f).load()
    found = _foreign_paths(att_dict, "", [])
    if found:
        path, qualname = found[0]
        raise ValueError(f"{Path(source).name}: attribute {path.lstrip('[').split(']')[0]}, at "
                         f"{path}, holds a {qualname} object, which cannot be read without JAX "
                         f"(ROADMAP Queue 3 item 15); {len(found)} such object(s) in all")
    return att_dict


# The fit state a map carries between packages: DRTMD attributes
STATE_KEYS = ("obs_psi", "obs_group_id", "obs_x", "obs_special", "obs_tau_indices",
              "obs_fit_attr", "obs_fit_status", "obs_rss", "obs_llh")


def load_fit_state(md, state):
    """Put a fitted map's state into ``md``, a DRTMD that holds the same
    observations in the same order: ``state`` is a dict of numpy arrays and
    plain Python values under ``STATE_KEYS`` (each observation's psi, group
    id, coefficients on the supergrid, special parameters by name, tau
    window, stored fit attributes, fit status, rss and llh), such as the JAX
    package's DRTMD holds after ``fit_all(batched=True)``. ``md`` can then
    rebuild and resolve those fits (``get_fits_batched``,
    ``resolve_group``) without fitting them."""
    n = len(state["obs_fit_status"])
    if n != md.num_obs:
        raise ValueError(f"the state has {n} observations; the map holds {md.num_obs}")
    md.obs_psi = np.array(state["obs_psi"], dtype=float)
    md.obs_group_id = list(state["obs_group_id"])
    md.obs_x = np.array(state["obs_x"], dtype=float)
    md.obs_special = {k: np.array(v, dtype=float) for k, v in state["obs_special"].items()}
    md.obs_tau_indices = [None if t is None else (int(t[0]), int(t[1]))
                          for t in state["obs_tau_indices"]]
    md.obs_fit_attr = deepcopy(list(state["obs_fit_attr"]))
    md.obs_fit_status = np.array(state["obs_fit_status"], dtype=bool)
    md.obs_rss = np.array(state["obs_rss"], dtype=float)
    md.obs_llh = np.array(state["obs_llh"], dtype=float)
    # the special parameters' names and sizes, which special_param_shape reads
    md.drt1d.special_qp_params = {k: {"size": 1 if v.ndim == 1 else v.shape[1]}
                                  for k, v in md.obs_special.items()}
    md.obs_special_resolved = {k: np.zeros_like(v) for k, v in md.obs_special.items()}
    md.obs_special_filt = {k: np.zeros_like(v) for k, v in md.obs_special.items()}
    return md
