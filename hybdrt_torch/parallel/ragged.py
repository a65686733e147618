"""Ragged batches: EIS spectra, or hybrid (chrono + EIS) observations, on
their own grids, protocols and basis windows, fitted as one padded and masked
batch.

Counterpart of ``hybdrt_tpu/parallel/ragged.py::BatchedRaggedFitter``. Every
observation's QP system is assembled exactly as the single fit assembles it
(``DRT._qphb_fit_core(prep_only=True)``), then padded into one batch:

* data rows are padded to the batch's most; a padded row has a zero design
  row, zero data and a zero variance-matrix row, so it drops out of the
  weighted QP and the weight estimate, and ``pred_stop`` averages over the
  real rows only;
* basis windows are padded to the widest; a padded column is decoupled from
  the penalty and pinned by a unit diagonal, with ``l1v = 1`` and ``lb = 0``
  there, so the QP holds it at its bound and the loop sets it to exactly 0;
* a hybrid observation's row structure rides along as per-lane vectors: the
  chrono/EIS weight factor of each row, and the vz-offset column's sign (+1
  on chrono rows, -1 on EIS rows) and strength.

The matrix stacks are kept once per measurement protocol (frequency grid, or
time grid, input signal and frequency grid) on the host and gathered to the
whole batch on the device, and the fit runs the port's live-lane loop over
per-lane systems (``solver/fitcore.py``). One batch holds one data type.
A padded n above the lane kernels' tile rule takes the QP's library route
(``ops/qp.py::library_route``), as the single fit's does: the JAX fitter
refuses no size either.

With ``qp_fused`` every warm QP of a live lane runs ``qp_max_iter_warm``
fixed Mehrotra steps in one launch of the fused kernel
(``ops/ip_lane.py::ip_steps_lane``) over the lanes' own (P, q, lb), the
padded columns pinned as in the plain path, or above that kernel's rule the
same steps as a loop (``ops/qp.py::fused_route``); iteration 0 runs cold over
every lane first, as in the JAX fitter (``hybdrt_tpu/parallel/ragged.py:101-106``).
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import preprocessing as pp
from ..models.drt import DRT, overfit_hypers, qphb_hypers
from ..solver import fitcore, qphb as qphb_mod
from ..solver.qphb import QPHBConfig
from ..utils.device import resolve_device


class RaggedFitResult(NamedTuple):
    """Physical-units results (leading axis = batch)."""
    x: np.ndarray               # (B, W_max) DRT coefficients (see tau_indices)
    tau_indices: list           # per-obs (left, right) window on the supergrid
    r_inf: np.ndarray
    inductance: np.ndarray
    c_inv: np.ndarray
    x_dop: Optional[np.ndarray]  # (B, n_nu) of a DOP batch, else None
    scale: np.ndarray           # (B,) coefficient scale
    weights: np.ndarray         # (B, R_max) final data weights (scaled space)
    rho: np.ndarray
    s_vectors: np.ndarray
    n_iter: np.ndarray
    converged: np.ndarray
    x_raw: np.ndarray           # (B, N_max) scaled parameter vectors
    num_rows: np.ndarray        # (B,) real data rows per obs
    num_chrono: np.ndarray      # (B,) chrono rows per obs (0: EIS only)


def _port_system(s):
    """A prep-only system of the port's DRT, or of the JAX package's (its
    ``cfg`` a NamedTuple), with the port's QPHBConfig; refuses what the port
    cannot fit."""
    if s["data_type"] not in ("eis", "chrono", "hybrid"):
        raise ValueError(f"data_type {s['data_type']!r}: expected 'eis', 'chrono' or 'hybrid'")
    if s.get("outlier_p") is not None:
        raise NotImplementedError("the outlier model is not ported yet (ROADMAP Queue 1 item 9)")
    cfg = s["cfg"]
    if not isinstance(cfg, QPHBConfig):
        # a nonlinear configuration raises here (QPHBConfig.__post_init__)
        s = dict(s, cfg=QPHBConfig(**(cfg._asdict() if hasattr(cfg, "_asdict") else cfg)))
    return s


def _check_consistent(systems):
    """All observations must share the QP layout (same special params/config)."""
    ref = systems[0]
    for s in systems[1:]:
        if s["cfg"] != ref["cfg"]:
            raise ValueError("Ragged batch requires identical QPHB config "
                             f"across observations; got {s['cfg']} vs {ref['cfg']}")
        if list(s["special_qp_params"]) != list(ref["special_qp_params"]):
            raise ValueError("Ragged batch requires identical special-parameter "
                             "layout across observations")
        if s["data_type"] != ref["data_type"]:
            raise ValueError("Ragged batch requires one data type per batch; "
                             "partition mixed observations by type first")


def _obs_data(chrono_data, eis_data):
    """(times, i_signal, v_signal, freq, z) of an observation, None where it
    has no such data, and its protocol key."""
    times, i_sig, v_sig = (chrono_data if chrono_data is not None and chrono_data[0] is not None
                           else (None, None, None))
    freq, z = eis_data if eis_data is not None and eis_data[0] is not None else (None, None)
    if times is None and freq is None:
        raise ValueError("an observation has neither chrono nor EIS data")
    key = (None if times is None else np.asarray(times).tobytes(),
           None if i_sig is None else np.asarray(i_sig).tobytes(),
           None if freq is None else np.asarray(freq).tobytes())
    return (times, i_sig, v_sig, freq, z), key


class BatchedRaggedFitter:
    """Self-tuning QPHB fits of observations on their own frequency grids,
    chrono protocols and basis windows, as one batch.

    Usage:
        fitter = BatchedRaggedFitter(tau_supergrid, dtype=torch.float32)
        result = fitter.fit(observations)
    where each observation is ((times, i_signal, v_signal) | None,
    (freq, z) | None), all of one data type: EIS, chrono or hybrid.
    ``fit_kw`` are the single fit's keywords (``DRT._qphb_fit_core``), for
    example ``downsample``; ``qp_fused`` fuses the warm QPs
    (``qp_max_iter_warm`` defaults to 8 with it). ``fit_dop`` (on
    ``fixed_basis_nu``, else the default nu basis) and ``fit_capacitance``
    add the DOP block and the C_inv column to every observation's system.

    The fitter runs on the CUDA card unless ``device="cpu"`` is given, and
    raises ``RuntimeError`` where no card is present. The JAX fitter's
    ``batch_bucket`` (padding the batch to a power of two, so that XLA need
    not recompile for a new batch size) is not taken: nothing here compiles
    per shape.
    """

    # Fit kwargs that make the QP system or its scale depend on the data, not
    # only on the frequency grid; they turn off the shared-system fast path
    _DATA_DEPENDENT_KW = frozenset({
        "solve_rp", "remove_extremes", "remove_outliers", "return_outlier_index",
        "scale_data", "update_scale", "subtract_background", "series_neg"})

    def __init__(self, tau_supergrid, fit_ohmic=True, fit_inductance=True,
                 fit_capacitance=False, fit_dop=False, nonneg=True, dtype=torch.float64,
                 device=None, max_iter=50, xtol=1e-2, qp_max_iter=60, qp_max_iter_warm=None,
                 mesh=None, step_model="ideal", chrono_mode="galv", fixed_basis_nu=None,
                 fit_kw=None, per_obs_penalty=True, pred_stop=False, pred_rtol=1e-2,
                 qp_fused=False, **hyper_kw):
        if mesh is not None:
            raise NotImplementedError("mesh: multi-GPU sharding is not ported yet "
                                      "(ROADMAP Queue 1 item 10)")
        if "batch_bucket" in hyper_kw:
            raise TypeError("batch_bucket is not taken: it padded the batch only so that XLA "
                            "would not recompile, and nothing here compiles per shape")
        # a misspelt hyperparameter fails here, not in prepare
        qphb_hypers(fit_dop=fit_dop, **hyper_kw)
        self.tau_supergrid = np.asarray(tau_supergrid, dtype=float)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.nonneg = nonneg
        self.max_iter = max_iter
        self.xtol = xtol
        self.qp_max_iter = qp_max_iter
        self.qp_fused = bool(qp_fused)
        if self.qp_fused and qp_max_iter_warm is None:
            # the fused path's fixed step count (hybdrt_tpu/parallel/ragged.py:102-106)
            qp_max_iter_warm = 8
        self.qp_max_iter_warm = qp_max_iter_warm
        self.pred_stop = bool(pred_stop)
        self.pred_rtol = float(pred_rtol)
        self.fit_kw = dict(fit_kw or {})
        self.hyper_kw = hyper_kw
        # per_obs_penalty=True carries each observation's own penalty stack
        # (B, 3, N, N) for parity with the single fits; False shares the
        # widest window's (equal on the log-uniform supergrid up to the last
        # ulp, which the loop can amplify; hybdrt_tpu/parallel/ragged.py:112)
        self.per_obs_penalty = per_obs_penalty
        self._drt_kw = dict(tau_supergrid=self.tau_supergrid, fit_ohmic=fit_ohmic,
                            fit_inductance=fit_inductance, fit_capacitance=fit_capacitance,
                            fit_dop=fit_dop, fixed_basis_nu=fixed_basis_nu,
                            step_model=step_model, chrono_mode=chrono_mode, warn=False,
                            device=self.device, dtype=dtype)
        DRT(**self._drt_kw)  # an unported step model or mode fails here
        self._drt_cache = {}
        self._sys_cache = {}
        self._given_systems = None

    @classmethod
    def from_systems(cls, systems, tau_supergrid, device=None, dtype=torch.float64, **kw):
        """Fitter over observations given as assembled systems: the dicts
        of ``DRT._qphb_fit_core(prep_only=True)``, this package's or the JAX
        package's (numpy arrays; its ``cfg`` a NamedTuple). ``fit()`` with no
        observations fits them. Systems that share one design-matrix array
        are one protocol, as in ``prepare``. ``kw`` are the constructor's
        loop options (max_iter, qp_max_iter, pred_stop, ...)."""
        self = cls(tau_supergrid, device=device, dtype=dtype, **kw)
        self._given_systems = [_port_system(s) for s in systems]
        return self

    def _fast_path_ok(self):
        return not (self._DATA_DEPENDENT_KW & set(self.fit_kw))

    # ------------------------------------------------------------------
    def _prep_obs(self, chrono_data, eis_data):
        """Assemble one observation's QP system exactly as the single fit
        would (``DRT._qphb_fit_core(prep_only=True)``;
        ``hybdrt_tpu/parallel/ragged.py:142-254``). One DRT per protocol,
        whose assembly cache skips the matrix construction on a repeat; and,
        without data-dependent fit kwargs, the whole system of an EIS or
        hybrid protocol is cached and later observations only redo the data
        scaling (``_eis_rescale_batch``, ``_hybrid_rescale``).

        A hybrid system also carries its host-resolved weight factors,
        ``host_eis_wf`` and ``host_chrono_wf``: the explicit ones, or the
        ``"rp"`` method's, computed from the prep state as the single fit
        does; None leaves the factor to the device (the ``"weight"``
        method)."""
        (times, i_sig, v_sig, freq, z), key = _obs_data(chrono_data, eis_data)
        tmpl = self._sys_cache.get(key)
        if tmpl is not None:
            if tmpl["data_type"] == "hybrid":
                return self._hybrid_rescale_batch(tmpl, [(v_sig, z)])[0]
            return self._eis_rescale_batch(tmpl, [z])[0]
        drt = self._drt_cache.get(key)
        if drt is None:
            if len(self._drt_cache) > 64:
                self._drt_cache.clear()
            drt = self._drt_cache[key] = DRT(**self._drt_kw)
        sys_ = drt._qphb_fit_core(times, i_sig, v_sig, freq, z, nonneg=self.nonneg,
                                  prep_only=True, **self.fit_kw, **self.hyper_kw)
        ewf = cwf = None
        if sys_["data_type"] == "hybrid":
            ewf, cwf = sys_["eis_weight_factor"], sys_["chrono_weight_factor"]
            if sys_["hybrid_weight_factor_method"] == "rp" and (ewf is None or cwf is None):
                rp_eis = pp.estimate_rp(None, None, None, None, None, drt.z_fit)
                rp_chrono = pp.estimate_rp(drt.get_fit_times(), drt.step_times, drt.step_sizes,
                                           drt.raw_response_signal, drt.step_model, None)
                rp_tot = drt.coefficient_scale * sys_["hypers"]["rp_scale"]
                if ewf is None:
                    ewf = rp_eis ** 0.75 / (rp_chrono ** 0.25 * rp_tot ** 0.5)
                if cwf is None:
                    cwf = rp_chrono ** 0.75 / (rp_eis ** 0.25 * rp_tot ** 0.5)
        sys_["host_eis_wf"] = ewf
        sys_["host_chrono_wf"] = cwf
        if self._fast_path_ok() and sys_["data_type"] != "chrono":
            if sys_["data_type"] == "hybrid":
                # The protocol's chrono state that the rescale needs, with
                # the downsampling's sample index and antialiasing replay
                # (:231-245)
                downsample = bool(self.fit_kw.get("downsample", False))
                sys_["fp_times"] = np.asarray(times, dtype=float)
                sys_["fp_sample_index"] = np.asarray(drt.sample_index)
                sys_["fp_filter"] = downsample and (self.fit_kw.get("downsample_kw") or {}).get(
                    "antialiased", True)
                sys_["fp_step_index"] = (pp.get_step_indices_from_step_times(
                    sys_["fp_times"], drt.nonconsec_step_times) if sys_["fp_filter"] else None)
                sys_["fp_step_times"] = np.atleast_1d(drt.step_times)
                sys_["fp_step_sizes"] = np.atleast_1d(drt.step_sizes)
                sys_["fp_offset_baseline"] = bool(self.fit_kw.get("offset_baseline", True))
            if len(self._sys_cache) > 64:
                self._sys_cache.clear()
            self._sys_cache[key] = sys_
        return sys_

    @staticmethod
    def _eis_rescale_batch(tmpl, z_list):
        """The fast path's rescale (scale_data's EIS branch,
        ``preprocessing.estimate_rp``) for observations sharing a cached
        grid, in one vectorized pass (:371)."""
        z = np.asarray(z_list, dtype=complex)
        zr = z.real
        rp_est = np.maximum(zr.max(axis=1), 0.0) - np.minimum(zr.min(axis=1), np.inf)
        scale = rp_est / tmpl["hypers"]["rp_scale"]
        z_scaled = z / scale[:, None]
        outs = []
        for i in range(len(z_list)):
            sys_ = dict(tmpl)
            sys_["rzv"] = np.concatenate([z_scaled[i].real, z_scaled[i].imag])
            sys_["coefficient_scale"] = scale[i]
            sys_["impedance_scale"] = scale[i]
            outs.append(sys_)
        return outs

    def _hybrid_rescale_batch(self, tmpl, items):
        """The fast path's rescale for hybrid observations ``items`` [(v, z),
        ...] sharing a cached protocol, in one vectorized pass
        (``_hybrid_rescale`` :256 and ``_hybrid_rescale_batch`` :314): what
        the single prep does with (v, z), in its order. With downsampling the
        response is filtered (``filter_chrono_signal_batch``, the antialiasing
        replay) and decimated to the protocol's samples first. The joint
        chrono/EIS Rp estimate (``estimate_rp_batch``) sets the coefficient,
        impedance and response scales; the scaled response less its median
        before the first step, and the scaled spectrum, make rzv; and the
        ``"rp"`` method's weight factors are recomputed from this data."""
        v = np.asarray([it[0] for it in items], dtype=float)
        z = np.asarray([it[1] for it in items], dtype=complex)
        if tmpl["fp_filter"]:
            v = pp.filter_chrono_signal_batch(tmpl["fp_times"], v, tmpl["fp_step_index"])
        v = v[:, tmpl["fp_sample_index"]]
        st, ss = tmpl["fp_step_times"], tmpl["fp_step_sizes"]
        sample_times = np.asarray(tmpl["sample_times"])
        step_model = self._drt_kw["step_model"]
        rp_est = pp.estimate_rp_batch(sample_times, st, ss, v, step_model, z)
        scale = rp_est / tmpl["hypers"]["rp_scale"]
        response_scale = tmpl["input_signal_scale"] * scale
        v_scaled = v / response_scale[:, None]
        if tmpl["fp_offset_baseline"]:
            offset = -np.median(v_scaled[:, sample_times < st[0]], axis=1)
        else:
            offset = np.zeros(len(items))
        z_scaled = z / scale[:, None]
        ewf, cwf = tmpl["eis_weight_factor"], tmpl["chrono_weight_factor"]
        if tmpl["hybrid_weight_factor_method"] == "rp" and (ewf is None or cwf is None):
            rp_eis = pp.estimate_rp_batch(None, None, None, None, step_model, z)
            rp_chrono = pp.estimate_rp_batch(sample_times, st, ss, v, step_model, None)
            # rp_tot = coefficient_scale * rp_scale = rp_est (models/drt.py)
            ewf_b = (rp_eis ** 0.75 / (rp_chrono ** 0.25 * rp_est ** 0.5)
                     if ewf is None else np.full(len(items), ewf))
            cwf_b = (rp_chrono ** 0.75 / (rp_eis ** 0.25 * rp_est ** 0.5)
                     if cwf is None else np.full(len(items), cwf))
        else:
            ewf_b = np.full(len(items), np.nan if ewf is None else ewf)
            cwf_b = np.full(len(items), np.nan if cwf is None else cwf)
        outs = []
        for i in range(len(items)):
            sys_ = dict(tmpl)
            sys_["rzv"] = np.concatenate([v_scaled[i] + offset[i], z_scaled[i].real,
                                          z_scaled[i].imag])
            sys_["coefficient_scale"] = scale[i]
            sys_["impedance_scale"] = scale[i]
            sys_["response_signal_scale"] = response_scale[i]
            sys_["scaled_response_offset"] = offset[i]
            sys_["host_eis_wf"] = None if np.isnan(ewf_b[i]) else ewf_b[i]
            sys_["host_chrono_wf"] = None if np.isnan(cwf_b[i]) else cwf_b[i]
            outs.append(sys_)
        return outs

    def _prep_systems(self, observations):
        """Per-observation prep; observations whose protocol's system is
        cached are rescaled in one vectorized pass per protocol (the first
        observation of a protocol takes the full prep and caches it for the
        rest; :389)."""
        systems = [None] * len(observations)
        pending = {}
        for idx, (c, e) in enumerate(observations):
            (_, _, v_sig, _, z), key = _obs_data(c, e)
            if key in self._sys_cache:
                pending.setdefault(key, []).append((idx, v_sig, z))
            else:
                systems[idx] = self._prep_obs(c, e)
        for key, items in pending.items():
            tmpl = self._sys_cache[key]
            if tmpl["data_type"] == "hybrid":
                outs = self._hybrid_rescale_batch(tmpl, [(v, z) for _, v, z in items])
            else:
                outs = self._eis_rescale_batch(tmpl, [z for _, _, z in items])
            for (idx, _, _), s in zip(items, outs):
                systems[idx] = s
        return systems

    def prepare(self, observations):
        """Prep and pad every observation; returns the per-observation host
        vectors ({"rzv": (B, R_max), "var_floor": (B,)}, and for hybrid
        batches "host_row_factors" (B, R_max), NaN where the device's
        factor holds) and keeps the per-protocol matrix stacks (``_uniq``)
        for ``fit``."""
        return self._prepare_systems(self._prep_systems(observations))

    def _prepare_systems(self, systems):
        """The padding of ``prepare`` (:422-577)."""
        if not systems:
            raise ValueError("no observations to fit")
        _check_consistent(systems)
        ref = systems[0]
        cfg = ref["cfg"]
        data_type = ref["data_type"]
        hybrid = data_type == "hybrid"
        n_rows = np.array([s["rzv"].shape[0] for s in systems])
        n_cols = np.array([s["rzm"].shape[1] for s in systems])
        r_max, n_max, b = int(n_rows.max()), int(n_cols.max()), len(systems)

        # The widest window's penalty stack, bounds and l1 vector: on the
        # log-uniform supergrid a narrower window's are its leading slices
        wide = int(np.argmax(n_cols))
        self.m_stack = np.zeros((3, n_max, n_max))
        self.m_stack[:, :n_cols[wide], :n_cols[wide]] = systems[wide]["m_stack"]
        self.lb = np.zeros(n_max)
        self.lb[:n_cols[wide]] = systems[wide]["lb"]
        l1_wide = np.zeros(n_max)
        l1_wide[:n_cols[wide]] = systems[wide]["l1_lambda_vector"]

        batch = {"rzv": np.zeros((b, r_max)), "var_floor": np.zeros(b)}
        if hybrid:
            # NaN: the device's weight factor (the "weight" method, or 1)
            batch["host_row_factors"] = np.full((b, r_max), np.nan)
        # Observations of one protocol share one design-matrix array (the
        # prep caches), so its identity partitions the batch; the O(R N)
        # stacks are padded once per protocol and gathered on the device
        proto_of = {}
        proto_index = np.array([proto_of.setdefault(id(s["rzm"]), len(proto_of))
                                for s in systems], dtype=np.int64)
        first_of_proto = np.array([int(np.argmax(proto_index == p))
                                   for p in range(len(proto_of))])
        n_proto = len(first_of_proto)
        uniq = {
            "rzm": np.zeros((n_proto, r_max, n_max)),
            "vmm": np.zeros((n_proto, r_max, r_max)),
            "row_mask": np.zeros((n_proto, r_max)),
            "col_mask": np.zeros((n_proto, n_max)),
            "l1v": np.zeros((n_proto, n_max)),
            "lb": np.zeros((n_proto, n_max)),
        }
        if self.per_obs_penalty:
            uniq["m_stack"] = np.zeros((n_proto, 3, n_max, n_max))
        if hybrid:
            uniq.update(rzm_vz=np.zeros((n_proto, r_max, n_max)),
                        vz_strength=np.zeros((n_proto, r_max)),
                        vz_sign=np.zeros((n_proto, r_max)),
                        chrono_row_mask=np.zeros((n_proto, r_max)))
        for p, i in enumerate(first_of_proto):
            s = systems[i]
            r_i, n_i = s["rzv"].shape[0], s["rzm"].shape[1]
            if hybrid:
                nc_i = s["num_chrono"]
                uniq["rzm_vz"][p, :r_i, :n_i] = s["rzm_vz"]
                uniq["vz_strength"][p, :r_i] = s["vz_strength_vec"]
                uniq["vz_sign"][p, :nc_i] = 1.0
                uniq["vz_sign"][p, nc_i:r_i] = -1.0
                uniq["chrono_row_mask"][p, :nc_i] = 1.0
            uniq["rzm"][p, :r_i, :n_i] = s["rzm"]
            uniq["vmm"][p, :r_i, :r_i] = s["vmm"]
            uniq["row_mask"][p, :r_i] = 1.0
            uniq["col_mask"][p, :n_i] = 1.0
            # Padded columns: unit linear cost and lb = 0, so the QP pins
            # them at the bound non-degenerately (x = 0, dual = 1)
            uniq["l1v"][p] = l1_wide * uniq["col_mask"][p] + (1.0 - uniq["col_mask"][p])
            uniq["lb"][p] = np.where(uniq["col_mask"][p] > 0, self.lb, 0.0)
            if self.per_obs_penalty:
                uniq["m_stack"][p, :, :n_i, :n_i] = s["m_stack"]

        tau_indices, scales = [], []
        for i, s in enumerate(systems):
            r_i = s["rzv"].shape[0]
            batch["rzv"][i, :r_i] = s["rzv"]
            batch["var_floor"][i] = np.var(s["rzv"]) * 1e-7
            if hybrid:
                nc_i = s["num_chrono"]
                if s.get("host_chrono_wf") is not None:
                    batch["host_row_factors"][i, :nc_i] = s["host_chrono_wf"]
                if s.get("host_eis_wf") is not None:
                    batch["host_row_factors"][i, nc_i:r_i] = s["host_eis_wf"]
            left = pp.nearest_index(self.tau_supergrid, s["basis_tau"][0])
            right = pp.nearest_index(self.tau_supergrid, s["basis_tau"][-1]) + 1
            tau_indices.append((int(left), int(right)))
            scales.append(s["coefficient_scale"])

        self.weight_factor = float(ref["weight_factor"] or 1.0)
        self._proto_index = proto_index
        self._first_of_proto = first_of_proto
        self._uniq = uniq
        self.cfg = cfg
        self.hypers = ref["hypers"]
        self.hyp = qphb_mod.hypers_to_tensors(self.hypers, self.device, self.dtype)
        iw_hypers = overfit_hypers(self.hypers, ref["iw_l1_lambda_0"], ref["iw_l2_lambda_0"])
        self.iw_hyp = qphb_mod.hypers_to_tensors(iw_hypers, self.device, self.dtype)
        self.special_qp_params = ref["special_qp_params"]
        self.inductance_scale = ref["inductance_scale"]
        self.capacitance_scale = ref["capacitance_scale"]
        # The DOP block lies at the same columns in every observation, so
        # the reference observation's scale vector and smoothing matrices
        # apply batch-wide (hybdrt_tpu/parallel/ragged.py:555-560)
        self.dop_scale_vector = None if ref.get("dop_scale_vector") is None \
            else np.asarray(ref["dop_scale_vector"], dtype=float)
        self.dop_gmat = None if ref.get("dop_gmat") is None \
            else np.stack([np.asarray(g, dtype=float) for g in ref["dop_gmat"]])
        self.data_type = data_type
        self.hybrid_wf_method = ref["hybrid_weight_factor_method"]
        # The ragged loop takes the chrono/EIS split per lane (row factors
        # and vz_sign), so num_chrono stays 0 here, as in the JAX fitter
        self.fcfg = fitcore.FitConfig(cfg=cfg, data_type=data_type, vz_offset=ref["vz_offset"],
                                      vz_index=ref["vz_index"], max_iter=self.max_iter,
                                      x_rtol=self.xtol, qp_max_iter=self.qp_max_iter,
                                      qp_max_iter_warm=self.qp_max_iter_warm,
                                      pred_stop=self.pred_stop, pred_rtol=self.pred_rtol,
                                      qp_fused=self.qp_fused)
        self._tau_indices = tau_indices
        self._scales = np.asarray(scales, dtype=float)
        self._n_rows = n_rows
        self._n_chrono = np.array([s["num_chrono"] for s in systems])
        self._last_batch = batch
        return batch

    def _per_proto_matvec(self, key, x):
        """y[i] = uniq[key][proto(i)] @ x[i], one protocol at a time."""
        u = self._uniq[key]
        pidx = self._proto_index[:x.shape[0]]
        y = np.zeros((x.shape[0], u.shape[1]))
        for p in range(u.shape[0]):
            m = pidx == p
            if m.any():
                y[m] = x[m] @ u[p].T
        return y

    def full(self, key):
        """One per-protocol stack gathered to the whole batch (B, ...)."""
        return self._uniq[key][self._proto_index]

    def final_predictions(self, result):
        """Model predictions y_hat (B, R_max) at the final iterate on each
        observation's own rows ([chrono;] Re; Im), zero on padded rows. A
        hybrid fit's vz-offset column is the loop's last rewrite, from the
        final iterate (:600-613)."""
        x = np.asarray(result.x_raw)
        y = self._per_proto_matvec("rzm", x)
        ci = self.fcfg.vz_index
        if self.fcfg.vz_offset and ci >= 0:
            newcol = self._per_proto_matvec("rzm_vz", x) * self.full("vz_sign") \
                * self.full("vz_strength")
            oldcol = self._uniq["rzm"][self._proto_index[:len(x)], :, ci]
            y = y + x[:, ci:ci + 1] * (newcol - oldcol)
        return y

    def final_design_matrices(self, result):
        """The per-observation design matrices (B, R_max, N_max) as they
        stood at the last pass, the vz-offset column rewritten from the
        final iterate (:615-627)."""
        rzm = self.full("rzm")
        if self.fcfg.vz_offset and self.fcfg.vz_index >= 0:
            y_vz = self._per_proto_matvec("rzm_vz", np.asarray(result.x_raw))
            rzm[:, :, self.fcfg.vz_index] = y_vz * self.full("vz_sign") * self.full("vz_strength")
        return rzm

    def posterior(self, observations, x_raw, rho, s_vectors, weights):
        """Each observation's posterior (P, q) at its final fit state: the
        weighted QP of its last outer iteration, rebuilt in float64 on the
        fitter's device (``hybdrt_tpu/mapping/drtmd.py:1238-1318``).

        ``observations`` are re-prepared through the protocol cache
        (``_prep_systems``), so their systems are those the fit solved; the
        per-observation ``x_raw`` (N_i,), ``rho`` (3,), ``s_vectors`` (3,
        N_i) and ``weights`` (R_i,) are a fit's, unpadded. One
        ``calculate_pq`` runs per protocol (observations that share one
        design-matrix array, hyperparameters and config), a hybrid
        protocol's design with each lane's final vz-offset column, and each
        protocol's stacks are copied to the host once. A DOP system's block
        takes its derivative strengths at 1, as the JAX map's rebuild takes
        them whatever the fit's were (ROADMAP Queue 3 item 20). Returns (systems, [P_i (N_i, N_i)], [q_i (N_i,)]), host
        float64 arrays, aligned with ``observations``."""
        systems = self._prep_systems(observations)
        dev, f64 = self.device, torch.float64
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=float), dtype=f64, device=dev)
        groups = {}
        for k, s in enumerate(systems):
            groups.setdefault((id(s["rzm"]), id(s["hypers"]), s["cfg"]), []).append(k)
        p_out, q_out = [None] * len(systems), [None] * len(systems)
        for ks in groups.values():
            s0 = systems[ks[0]]
            stack = lambda vals: t(np.stack([vals[k] for k in ks]))
            rzm = t(s0["rzm"])
            if s0["vz_offset"]:
                x = stack(x_raw)
                sign = fitcore.chrono_eis_sign(s0["num_chrono"], rzm.shape[0], x)
                col = qphb_mod._mv(t(s0["rzm_vz"]), x) * sign * t(s0["vz_strength_vec"])
                rzm = fitcore.with_vz_column(rzm, col, s0["vz_index"])
            dr = torch.ones(len(ks), s0["cfg"].k_range, dtype=f64, device=dev)
            p, q = qphb_mod.calculate_pq(
                rzm, t(np.stack([systems[k]["rzv"] for k in ks])), t(s0["m_stack"]),
                qphb_mod.hypers_to_tensors(s0["hypers"], dev, f64), t(s0["l1_lambda_vector"]),
                stack(rho), stack(s_vectors), stack(weights), s0["cfg"], dop_rho_vector=dr)
            p, q = p.cpu().numpy(), q.cpu().numpy()
            for bi, k in enumerate(ks):
                p_out[k], q_out[k] = p[bi], q[bi]
        return systems, p_out, q_out

    # ------------------------------------------------------------------
    def _device_arrays(self, batch):
        """The per-lane arrays on the device: each per-protocol stack uploaded
        once and gathered to the batch there (:932-961)."""
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=float), dtype=self.dtype,
                                      device=self.device)
        idx = torch.as_tensor(self._proto_index, device=self.device)
        arrays = {k: t(u).index_select(0, idx) for k, u in self._uniq.items()}
        arrays.update({k: t(v) for k, v in batch.items()})
        if self.data_type == "hybrid" and np.all(np.isnan(batch["host_row_factors"])):
            # no observation set a factor on the host: skip the upload
            arrays["host_row_factors"] = None
        if not self.per_obs_penalty:
            arrays["m_stack"] = t(self.m_stack)
        return arrays

    def _loop_args(self, arrays):
        """Weight initialization on the per-lane systems and the arguments
        of ``fitcore.qphb_fit_loop`` (``_loop_setup``, :629)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        rzv = arrays["rzv"]
        b, n = rzv.shape[0], arrays["rzm"].shape[2]
        rho0 = self.hyp["rho_0"]
        s0 = torch.stack([torch.full((n,), float(self.hypers["s_0"][k]), dtype=dt, device=dev)
                          for k in range(cfg.k_range)])
        masks = dict(col_mask=arrays["col_mask"], var_floor=arrays["var_floor"])
        dop_rho0 = self.hyp.get("dop_rho_0")
        if dop_rho0 is None:
            dop_rho0 = torch.ones(cfg.k_range, dtype=dt, device=dev)
        est, init_w, _, out_t = qphb_mod.initialize_weights(
            self.iw_hyp, arrays["m_stack"], rho0, s0, rzv, arrays["rzm"], arrays["vmm"],
            arrays["lb"], cfg, dop_rho_vector=dop_rho0, **masks)
        lanes = lambda v: v.expand(b, *v.shape).clone()
        x0 = torch.full((b, n), 1e-6, dtype=dt, device=dev)
        args = (arrays["rzm"], rzv, arrays["vmm"], arrays["m_stack"], arrays["l1v"],
                arrays["lb"], self.hyp, x0, lanes(s0), lanes(rho0), lanes(dop_rho0), init_w,
                est, out_t, self.fcfg)
        kw = dict(masks, row_mask=arrays["row_mask"], weight_factor=self.weight_factor)
        if self.dop_gmat is not None:
            kw["dop_gmat"] = torch.as_tensor(self.dop_gmat, dtype=dt, device=dev)
        if self.data_type == "hybrid":
            kw["row_factors"] = self._row_factors(est, arrays)
            if self.fcfg.vz_offset:
                kw.update(rzm_vz=arrays["rzm_vz"], vz_strength=arrays["vz_strength"],
                          vz_sign=arrays["vz_sign"])
        return args, kw

    def _row_factors(self, est, arrays):
        """Each row's chrono/EIS weight factor (B, R_max) (:655-670): with
        the "weight" method, per lane from its estimated weights'
        chrono and EIS scales; else 1; and the host-resolved factors where
        given."""
        row_mask, chrono = arrays["row_mask"], arrays["chrono_row_mask"]
        if self.hybrid_wf_method == "weight":
            eis = row_mask - chrono
            c_scale = (torch.sum(chrono * est ** -2, dim=-1)
                       / torch.clamp(torch.sum(chrono, dim=-1), min=1.0)) ** -0.5
            e_scale = (torch.sum(eis * est ** -2, dim=-1)
                       / torch.clamp(torch.sum(eis, dim=-1), min=1.0)) ** -0.5
            ratio = ((e_scale / c_scale) ** 0.25)[:, None]
            factors = chrono * ratio + (1.0 - chrono) / ratio
        else:
            factors = torch.ones_like(row_mask)
        host = arrays["host_row_factors"]
        if host is not None:
            factors = torch.where(torch.isnan(host), factors, host)
        return factors

    def fit(self, observations=None, return_states=False, return_history=False,
            adaptive=False, phase_budgets=None, staged_capacities=None, staged_buckets=None):
        """Fit EIS observations of mixed grids as one batch; returns a
        RaggedFitResult (with ``return_states``, also the final per-lane
        state). ``observations`` None fits the systems given to
        ``from_systems``. ``return_history`` also returns every pass's state
        (``fitcore.qphb_fit_scan``), a dict of (B, max_iter, ...) arrays
        after the result (and the states), as the JAX fitter does
        (:1000-1012); it cannot be combined with ``adaptive``.

        adaptive=False, True and "staged" all run every lane in the port's
        live-lane loop, which steps only the lanes still live, so no lane
        waits on another; the JAX fitter's staged compaction existed because
        a vmapped while_loop runs every lane to the slowest one. So
        ``phase_budgets``, ``staged_capacities`` and ``staged_buckets``,
        which budget that schedule, raise ValueError, as
        ``BatchedEISFitter.fit`` treats ``phase_budgets``."""
        if not (adaptive is False or adaptive is True
                or (isinstance(adaptive, str) and adaptive == "staged")):
            raise ValueError(f"adaptive={adaptive!r}: the ragged fitter supports False, True "
                             f"or 'staged'")
        for name, v in (("phase_budgets", phase_budgets),
                        ("staged_capacities", staged_capacities),
                        ("staged_buckets", staged_buckets)):
            if v is not None:
                raise ValueError(f"{name}: this fitter has no compaction schedule to budget; "
                                 f"every adaptive mode runs the live-lane loop")
        if return_history and adaptive:
            raise ValueError("return_history is a fixed-length scan; it cannot be combined "
                             "with staged compaction")
        if observations is None:
            if self._given_systems is None:
                raise ValueError("no observations given, and the fitter was not built "
                                 "from_systems")
            batch = self._prepare_systems(self._given_systems)
        else:
            batch = self.prepare(observations)
        args, kw = self._loop_args(self._device_arrays(batch))
        if return_history:
            states, history = fitcore.qphb_fit_scan(*args, **kw)
            out = self.collect(states, return_states=return_states,
                               row_factors=kw.get("row_factors"))
            return (*out, history) if return_states else (out, history)
        states = fitcore.qphb_fit_loop(*args, **kw)
        return self.collect(states, return_states=return_states,
                            row_factors=kw.get("row_factors"))

    def collect(self, states, return_states=False, row_factors=None):
        """Per-lane states -> RaggedFitResult in physical units; a hybrid
        fit's weights are the effective ones, the state's times its row
        factors (:1036)."""
        npy = lambda t: t.detach().cpu().numpy()
        x_full = npy(states.x)
        scale = self._scales
        ns = self.cfg.num_special
        sp = self.special_qp_params

        def special(name, col_scale=1.0):
            if name in sp:
                return x_full[:, sp[name]["index"]] * scale * col_scale
            return np.zeros(len(scale))

        x_dop = None
        if self.cfg.fit_dop:
            ds_, de_ = self.cfg.dop_start, self.cfg.dop_start + self.cfg.dop_size
            x_dop = x_full[:, ds_:de_] * self.dop_scale_vector[None, :] * scale[:, None]
        result = RaggedFitResult(
            x=x_full[:, ns:] * scale[:, None], tau_indices=self._tau_indices,
            r_inf=special("R_inf"), inductance=special("inductance", self.inductance_scale or 1.0),
            c_inv=special("C_inv", self.capacitance_scale or 1.0), x_dop=x_dop, scale=scale,
            weights=npy(states.weights if row_factors is None else states.weights * row_factors),
            rho=npy(states.rho_vector),
            s_vectors=npy(states.s_vectors), n_iter=npy(states.it),
            converged=npy(states.converged), x_raw=x_full, num_rows=self._n_rows,
            num_chrono=self._n_chrono)
        if return_states:
            return result, states
        return result
