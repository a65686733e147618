"""The single-spectrum DRT and the EIS problem assembly it shares with the
batched fitter.

Counterpart of ``hybdrt_tpu/models/drt.py`` for EIS data, the gaussian basis
and ``integrate_method="interp"``. The assembly (``_prep_for_fit`` :464,
``_prep_impedance_fit_matrix`` :613, ``_prep_penalty_matrices`` :657,
``_format_qp_matrices`` :695, ``_make_lower_bound`` :800) is a set of host
numpy functions in float64, which both ``DRT`` and ``build_eis_problem``
(``BatchedEISFitter``'s problem) call. ``DRT.fit_eis`` runs the port's
batched fit loop at B = 1 on its device, with the design matrix shared as in
``BatchedEISFitter``: on the card, its QPs launch the lane kernels at one
lane.

Options whose code lies in an unported layer raise ``NotImplementedError``
naming their ROADMAP Queue 1 item.
"""
import warnings

import numpy as np
import torch

from .. import preprocessing as pp
from ..ops import basis as basis_mod
from ..ops import chol_lane, lookup, mat1d
from ..solver import fitcore
from ..solver import hypers as hyp_mod
from ..solver import qphb as qphb_mod
from ..solver.qphb import QPHBConfig
from ..utils import eis as eis_utils
from ..utils import validation
from ..utils.device import resolve_device

# Keywords of the JAX ``_qphb_fit_core`` that only chrono and hybrid data use
# (hybdrt_tpu/models/drt.py:870-894); the port takes them only to refuse them
CHRONO_KW = ("step_times", "step_sizes", "offset_steps", "step_offset_size", "offset_baseline",
             "v_baseline_deg", "v_baseline_sqrt", "downsample", "downsample_kw",
             "smooth_inf_response", "subtract_background", "background_type",
             "background_corr_power", "estimate_background_kw", "v_baseline_penalty",
             "background_penalty", "init_weights_separately", "chrono_error_structure",
             "chrono_vmm_epsilon", "vz_offset", "vz_offset_scale", "vz_offset_eps",
             "eis_weight_factor", "chrono_weight_factor", "hybrid_weight_factor_method")


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


# ---------------------------------------------------------------------------
# Assembly, shared by DRT and build_eis_problem (host numpy, float64)
# ---------------------------------------------------------------------------
def default_tau_epsilon(fixed_basis_tau=None, tau_supergrid=None, basis_tau_ppd=10):
    """The basis functions' epsilon from the spacing of the first of these
    given (hybdrt_tpu/models/drt.py:145-151); None when none is."""
    if fixed_basis_tau is not None:
        return 1 / np.mean(np.diff(np.log(fixed_basis_tau)))
    if tau_supergrid is not None:
        return 1 / np.mean(np.diff(np.log(tau_supergrid)))
    if basis_tau_ppd is not None:
        return pp.get_epsilon_from_ppd(basis_tau_ppd)
    return None


def eis_basis_tau(frequencies, fixed_basis_tau=None, tau_supergrid=None, extend_decades=1):
    """``fixed_basis_tau``, else the slice of ``tau_supergrid`` that covers the
    data range +- extend_decades, else a 10-ppd grid over it (:476-481)."""
    if fixed_basis_tau is not None:
        return np.asarray(fixed_basis_tau, dtype=float)
    return pp.get_basis_tau(frequencies, extend_decades=extend_decades,
                            tau_grid=tau_supergrid)


def special_qp_params(fit_ohmic=True, fit_inductance=True):
    """The special columns before the DRT block, in the JAX package's order
    (:1061-1064)."""
    special = {}
    for name, on in (("R_inf", fit_ohmic), ("inductance", fit_inductance)):
        if on:
            special[name] = {"index": len(special), "nonneg": True, "size": 1}
    return special


def impedance_matrix(frequencies, basis_tau, tau_epsilon):
    """Complex (F, n_tau) matrix of the DRT block's impedance (:629-637)."""
    zre_lu, zim_lu = lookup.generate_impedance_lookup("gaussian", float(tau_epsilon))
    return mat1d.construct_impedance_matrix(frequencies, "real", basis_tau,
                                            epsilon=tau_epsilon, interpolate_grids=zre_lu) \
        + 1j * mat1d.construct_impedance_matrix(frequencies, "imag", basis_tau,
                                                epsilon=tau_epsilon, interpolate_grids=zim_lu)


def eis_design_matrix(zm_drt, frequencies, special, inductance_scale):
    """The impedance matrix with its special columns, stacked [Re; Im]
    (2F, N) (:746-758)."""
    ns = len(special)
    zm = np.zeros((zm_drt.shape[0], zm_drt.shape[1] + ns), dtype=complex)
    if "inductance" in special:
        zm[:, special["inductance"]["index"]] = \
            mat1d.construct_inductance_impedance_vector(frequencies) * inductance_scale
    if "R_inf" in special:
        zm[:, special["R_inf"]["index"]] = 1
    zm[:, ns:] = zm_drt
    return np.vstack([zm.real, zm.imag])


def base_penalty_matrices(basis_tau, tau_epsilon):
    """The DRT block's integrated-derivative penalties of orders 0..2,
    (3, n_tau, n_tau) (:668-673)."""
    return np.stack([mat1d.construct_integrated_derivative_matrix(
        np.log(basis_tau), order=k, epsilon=tau_epsilon) for k in range(3)])


def penalty_stack(base, special, penalties):
    """(3, N, N): each order's DRT block with the special columns' diagonal
    penalties ``penalties[name]`` before it (:762-794)."""
    ns = len(special)
    n = base.shape[-1] + ns
    m_stack = np.zeros((3, n, n))
    for k in range(3):
        m_stack[k, ns:, ns:] = base[k]
        for name, sp in special.items():
            m_stack[k, sp["index"], sp["index"]] = penalties[name]
    return m_stack


def make_lower_bound(n, nonneg, special, neg_allowed_indices=None):
    """The QP's lower bound (:800-815)."""
    if nonneg:
        lb = np.zeros(n)
        for sp in special.values():
            if not sp["nonneg"]:
                lb[sp["index"]:sp["index"] + sp["size"]] = -1000.0
    elif neg_allowed_indices is not None:
        lb = make_lower_bound(n, True, special)
        lb[neg_allowed_indices] = -1e5
    else:
        lb = np.full(n, -1e5)
        for sp in special.values():
            if sp["nonneg"]:
                lb[sp["index"]:sp["index"] + sp["size"]] = 0.0
    return lb


def qphb_hypers(eff_hp=True, **hyper_kw):
    """The default hyperparameters updated by ``hyper_kw``, each key checked
    (:1081-1085); the outlier model raises (item 9)."""
    hypers = hyp_mod.get_default_hypers(eff_hp=eff_hp, fit_dop=False)
    for key in hyper_kw:
        if key not in hypers:
            raise ValueError(f"Invalid keyword argument {key}")
    hypers.update(hyper_kw)
    if hypers.get("outlier_p") is not None:
        raise _unported("outlier_p: the outlier model", 9)
    return hypers


def overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0):
    """The weight initialization's hyperparameters (:1330-1332)."""
    iw_hypers = dict(hypers)
    iw_hypers["l1_lambda_0"] = iw_l1_lambda_0
    iw_hypers["l2_lambda_0"] = iw_l2_lambda_0
    return iw_hypers


def l1_vector(n, ns, hypers):
    l1v = np.zeros(n)
    l1v[ns:] = hypers["l1_lambda_0"]
    return l1v


def build_eis_problem(frequencies, basis_tau=None, tau_supergrid=None, fit_ohmic=True,
                      fit_inductance=True, nonneg=True, iw_l1_lambda_0=1e-4,
                      iw_l2_lambda_0=1e-4, fit_capacitance=False, fit_dop=False,
                      tau_basis_type="gaussian", integrate_method="interp", **hyper_kw):
    """Assemble the shared EIS QP problem for one frequency grid, as the JAX
    ``BatchedEISFitter`` reads it from a template ``DRT.fit_eis``
    (``hybdrt_tpu/parallel/batch.py:204-246``).

    The basis is ``basis_tau`` if given, else the slice of ``tau_supergrid``
    that covers the data range +- 1 decade, else a 10-ppd grid; epsilon
    follows the spacing of the first of these given (drt.py:145-151).

    Returns a dict of host float64 arrays and metadata: ``frequencies``,
    ``rzm`` (2F, N) design matrix stacked [Re; Im], ``vmm`` (2F, 2F)
    variance-averaging matrix,
    ``m_stack`` (3, N, N) penalty matrices, ``l1v`` (N,), ``lb`` (N,),
    ``hypers`` / ``iw_hypers`` (dicts of floats, arrays and None), ``cfg``,
    ``special_qp_params``, ``basis_tau``, ``tau_epsilon``, ``inductance_scale``,
    ``tau_supergrid`` (None without one).
    """
    if fit_dop:
        raise _unported("fit_dop: DOP assembly", 4)
    if fit_capacitance:
        raise _unported("fit_capacitance: capacitance assembly", 4)
    if tau_basis_type != "gaussian":
        raise _unported(f"tau_basis_type={tau_basis_type!r}: bases other than gaussian", 4)
    if integrate_method != "interp":
        raise _unported(f"integrate_method={integrate_method!r}: quadrature assembly", 4)

    hypers = qphb_hypers(eff_hp=True, **hyper_kw)
    frequencies = np.asarray(frequencies, dtype=float)
    if tau_supergrid is not None:
        tau_supergrid = np.asarray(tau_supergrid, dtype=float)
    tau_epsilon = default_tau_epsilon(basis_tau, tau_supergrid)
    basis_tau = eis_basis_tau(frequencies, basis_tau, tau_supergrid)

    special = special_qp_params(fit_ohmic, fit_inductance)
    ns = len(special)
    n = len(basis_tau) + ns
    inductance_scale = 1e-5
    rzm = eis_design_matrix(impedance_matrix(frequencies, basis_tau, tau_epsilon), frequencies,
                            special, inductance_scale)
    # ohmic_penalty = inductance_penalty = 1e-6 (drt.py:879-880)
    m_stack = penalty_stack(base_penalty_matrices(basis_tau, tau_epsilon), special,
                            {name: 1e-6 for name in special})
    vmm = mat1d.construct_eis_var_matrix(frequencies, 0.25, 0.25, None)
    cfg = QPHBConfig(num_special=ns, k_range=len(hypers["derivative_weights"]),
                     eff_hp=True, has_outlier=False)
    return {
        "frequencies": frequencies, "rzm": rzm, "vmm": vmm, "m_stack": m_stack,
        "l1v": l1_vector(n, ns, hypers), "lb": make_lower_bound(n, nonneg, special),
        "hypers": hypers, "iw_hypers": overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0),
        "cfg": cfg, "special_qp_params": special, "basis_tau": basis_tau,
        "tau_epsilon": float(tau_epsilon), "inductance_scale": inductance_scale,
        "tau_supergrid": tau_supergrid,
    }


# ---------------------------------------------------------------------------
# The single-spectrum DRT (hybdrt_tpu/models/drt.py:33), EIS fits
# ---------------------------------------------------------------------------
class DRT:
    """Distribution of relaxation times fitted to one EIS spectrum by the
    self-tuning QPHB loop.

    Usage:
        drt = DRT()                      # on the CUDA card, float64
        drt.fit_eis(freq, z)
        drt.fit_parameters["x"], drt.predict_r_p(), drt.predict_z(freq)

    ``device=None`` means the card (``RuntimeError`` where none is present;
    ``device="cpu"`` runs on the CPU). ``dtype`` is the fit's, float64 by
    default as the JAX ``DRT`` (``hybdrt_tpu/__init__.py:27``); the assembly
    is host float64 either way.
    """

    def __init__(self, fixed_basis_tau=None, tau_supergrid=None, tau_basis_type="gaussian",
                 basis_tau_ppd=10, extend_basis_decades=1,
                 interpolate_integrals=True, fit_dop=False, fit_inductance=True, fit_ohmic=True,
                 fit_capacitance=False, warn=True, device=None, dtype=torch.float64):
        validation.check_basis_type(tau_basis_type)
        if tau_basis_type != "gaussian":
            raise _unported(f"tau_basis_type={tau_basis_type!r}: bases other than gaussian", 4)
        if not interpolate_integrals:
            raise _unported("interpolate_integrals=False (integrate_method='trapz')", 4)
        if fit_dop:
            raise _unported("fit_dop: the distribution of phasances", 4)
        if fit_capacitance:
            raise _unported("fit_capacitance: the capacitance column", 4)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fixed_basis_tau = None if fixed_basis_tau is None else np.asarray(fixed_basis_tau)
        self.tau_supergrid = None if tau_supergrid is None else np.asarray(tau_supergrid)
        self.basis_tau = None
        self.tau_basis_type = tau_basis_type
        self.extend_basis_decades = extend_basis_decades
        self.integrate_method = "interp"
        self.fit_inductance = fit_inductance
        self.fit_ohmic = fit_ohmic
        self.warn = warn
        self.tau_epsilon = default_tau_epsilon(self.fixed_basis_tau, self.tau_supergrid,
                                               basis_tau_ppd)

        self.f_fit = []
        self.z_fit = None
        self.z_fit_scaled = None
        self.coefficient_scale = 1.0
        self.impedance_scale = 1.0
        self.inductance_scale = None
        self.special_qp_params = {}
        self.fit_parameters = None
        self.fit_type = None
        self.fit_matrices = {}
        self.qphb_params = None
        self.qphb_history = None
        self._assembly_cache = {}

    # ------------------------------------------------------------------
    def get_qp_mat_offset(self):
        return int(sum(v.get("size", 1) for v in self.special_qp_params.values()))

    @property
    def num_drt_params(self):
        return len(self.basis_tau)

    def _basis_signature(self):
        return (self.tau_basis_type, float(self.tau_epsilon),
                np.asarray(self.basis_tau, dtype=float).tobytes(), self.integrate_method)

    def _cached(self, key, build):
        """The assembly cache (:601-611): repeated preps on one grid and
        basis reuse their matrices."""
        hit = self._assembly_cache.get(key)
        if hit is None:
            if len(self._assembly_cache) > 32:
                self._assembly_cache.clear()
            hit = self._assembly_cache[key] = build()
        return hit

    def scale_data(self, z, apply_scaling, rp_scale):
        """EIS branch of ``scale_data`` (:398): the coefficient and impedance
        scale rp_est / rp_scale, and the scaled spectrum."""
        if apply_scaling:
            self.coefficient_scale = pp.estimate_rp(z) / rp_scale
        else:
            self.coefficient_scale = 1.0
        self.impedance_scale = self.coefficient_scale
        z_scaled = z / self.impedance_scale
        self.z_fit = z.copy()
        self.z_fit_scaled = z_scaled.copy()
        return z_scaled

    def update_data_scale(self, factor):
        self.z_fit_scaled = self.z_fit_scaled * factor
        self.coefficient_scale /= factor
        self.impedance_scale /= factor

    def _prep_impedance_fit_matrix(self, frequencies):
        self.f_fit = np.asarray(frequencies)
        zm = self._cached(("zm", self._basis_signature(), self.f_fit.tobytes()),
                          lambda: impedance_matrix(frequencies, self.basis_tau, self.tau_epsilon))
        self.fit_matrices["impedance"] = zm
        return zm

    def _prep_penalty_matrices(self):
        return self._cached(("pen", self._basis_signature()),
                            lambda: base_penalty_matrices(self.basis_tau, self.tau_epsilon))

    def _get_neg_allowed_indices(self, nonneg, neg_allowed_tau_range):
        if nonneg and neg_allowed_tau_range is not None:
            raise ValueError("If nonneg==True, neg_allowed_tau_range cannot be specified")
        if not nonneg and neg_allowed_tau_range is not None:
            tau_min, tau_max = neg_allowed_tau_range
            index = np.where((self.basis_tau >= tau_min) & (self.basis_tau <= tau_max))[0]
            return index + self.get_qp_mat_offset()
        return None

    # ------------------------------------------------------------------
    def _qphb_fit_core(self, times, i_signal, v_signal, frequencies, z, nonneg=True,
                       neg_allowed_tau_range=None, series_neg=False, scale_data=True,
                       update_scale=False, solve_rp=False, ohmic_penalty=1e-6,
                       inductance_penalty=1e-6, inductance_scale=1e-5,
                       capacitance_scale=1e-3, remove_extremes=False, extreme_kw=None,
                       eis_error_structure=None, remove_outliers=False,
                       return_outlier_index=False, eis_vmm_epsilon=0.25,
                       eis_reim_cor=0.25, iw_l1_lambda_0=1e-4, iw_l2_lambda_0=1e-4, eff_hp=True,
                       weight_factor=1, xtol=1e-2, max_iter=50, store_history=False,
                       prep_only=False, **kw):
        """The EIS fit (``hybdrt_tpu/models/drt.py:870``, ``times is None``).
        ``prep_only=True`` returns the assembled system as the JAX dict
        (:1293-1324), numpy arrays, without fitting."""
        if times is not None or i_signal is not None or v_signal is not None:
            raise _unported("chrono and hybrid data", 6)
        chrono_kw = [k for k in CHRONO_KW if kw.pop(k, None) is not None]
        if chrono_kw:
            raise _unported(f"{chrono_kw}: the chrono and hybrid options", 6)
        if remove_outliers or return_outlier_index:
            raise _unported("remove_outliers / return_outlier_index: the outlier model", 9)
        if frequencies is None:
            raise ValueError("fit_eis needs frequencies and z")
        validation.check_eis_data(frequencies, z)
        validation.check_error_structure(eis_error_structure)
        if series_neg and not nonneg:
            raise ValueError("Only one of series_neg and nonneg may be True")
        if series_neg:
            raise NotImplementedError("series_neg is not ported yet")
        if weight_factor != 1:
            raise NotImplementedError(
                "weight_factor != 1: the port's fit loop applies no global weight factor "
                "(hybdrt_torch/solver/fitcore.py::_loop_body)")
        if update_scale:
            warnings.warn("update_scale (mid-fit data-scale refinement) is not implemented; "
                          "the scale is set once up front — use solve_rp=True for the refined "
                          "pre-fit Rp estimate instead")
        hypers = qphb_hypers(eff_hp=eff_hp, **kw)

        frequencies = np.array(frequencies, dtype=float)
        z = np.array(z, dtype=complex)
        if remove_extremes:
            if extreme_kw is None:
                extreme_kw = {"qr_size": 0.8, "qr_thresh": 1.5}
            flag = pp.identify_extreme_values(z.real, **extreme_kw) | \
                pp.identify_extreme_values(z.imag, **extreme_kw)
            if flag.any():
                if self.warn:
                    warnings.warn(f"Removing extreme EIS values at indices "
                                  f"{np.where(flag)[0].tolist()}")
                frequencies, z = frequencies[~flag], z[~flag]

        self.special_qp_params = special_qp_params(self.fit_ohmic, self.fit_inductance)
        ns = self.get_qp_mat_offset()

        # _prep_for_fit (:464): basis, matrices, data scale
        self.basis_tau = eis_basis_tau(frequencies, self.fixed_basis_tau, self.tau_supergrid,
                                       self.extend_basis_decades)
        if self.tau_epsilon is None:
            self.tau_epsilon = 1 / np.mean(np.diff(np.log(self.basis_tau)))
        zm_drt = self._prep_impedance_fit_matrix(frequencies)
        base_penalty = self._prep_penalty_matrices()
        z_scaled = self.scale_data(z, scale_data, hypers["rp_scale"])

        neg_allowed_indices = self._get_neg_allowed_indices(nonneg, neg_allowed_tau_range)
        self.inductance_scale = inductance_scale
        rzm = eis_design_matrix(zm_drt, frequencies, self.special_qp_params, inductance_scale)
        m_stack = penalty_stack(base_penalty, self.special_qp_params,
                                {"R_inf": ohmic_penalty, "inductance": inductance_penalty})
        n = rzm.shape[1]
        rzv = np.concatenate([z_scaled.real, z_scaled.imag])
        l1_lambda_vector = l1_vector(n, ns, hypers)
        k_range = len(hypers["derivative_weights"])
        rho_vector = np.array(hypers["rho_0"], dtype=float).copy()
        s_vectors = np.stack([np.ones(n) * hypers["s_0"][k] for k in range(k_range)])
        dop_rho_vector = np.ones(k_range)
        cfg = QPHBConfig(num_special=ns, k_range=k_range, eff_hp=eff_hp, has_outlier=False)
        lb = make_lower_bound(n, nonneg, self.special_qp_params, neg_allowed_indices)

        if scale_data and solve_rp:
            # Data-scale refinement from a quick elastic-net solve (:1210-1221)
            x_rp = self._to_numpy(qphb_mod.estimate_x_rp(
                self._hyp(hypers), self._t(m_stack), self._t(rho_vector), self._t(s_vectors),
                self._t(rzv)[None], self._t(rzm), self._t(lb), cfg))[0]
            rp_est = self.predict_r_p(absolute=True, x=x_rp, raw=True)
            scale_factor = hypers["rp_scale"] / rp_est
            rzv *= scale_factor
            self.update_data_scale(scale_factor)

        vmm = self._cached(("vmm_e", frequencies.tobytes(), float(eis_vmm_epsilon),
                            float(eis_reim_cor), eis_error_structure),
                           lambda: mat1d.construct_eis_var_matrix(
                               frequencies, eis_vmm_epsilon, eis_reim_cor, eis_error_structure))

        if prep_only:
            return {
                "rzm": rzm, "rzv": rzv, "vmm": vmm, "m_stack": m_stack,
                "l1_lambda_vector": l1_lambda_vector, "lb": lb, "s_vectors": s_vectors,
                "rho_vector": rho_vector, "dop_rho_vector": dop_rho_vector, "cfg": cfg,
                "rzm_vz": np.zeros_like(rzm), "vz_strength_vec": np.ones(rzm.shape[0]),
                "vz_offset": False, "vz_index": -1, "data_type": "eis", "num_chrono": 0,
                "num_eis": len(frequencies), "hypers": hypers, "dop_gmat": None,
                "outlier_p": None, "basis_tau": np.asarray(self.basis_tau),
                "special_qp_params": dict(self.special_qp_params),
                "coefficient_scale": self.coefficient_scale, "input_signal_scale": None,
                "response_signal_scale": None, "impedance_scale": self.impedance_scale,
                "v_baseline_scale": None, "dop_scale_vector": None,
                "inductance_scale": inductance_scale, "capacitance_scale": capacitance_scale,
                "sample_times": None, "frequencies": frequencies,
                "hybrid_weight_factor_method": None, "eis_weight_factor": None,
                "chrono_weight_factor": None, "weight_factor": weight_factor,
                "iw_l1_lambda_0": iw_l1_lambda_0, "iw_l2_lambda_0": iw_l2_lambda_0,
                "scaled_response_offset": None,
            }

        if self.device.type == "cuda" and not chol_lane.admitted(n, self.dtype):
            raise NotImplementedError(
                f"a QP of n={n} parameters in {self.dtype} exceeds the lane kernels' tile rule "
                f"(n <= 268 in float32, 188 in float64, ops/chol_lane.py::admitted); the dense "
                f"path for larger systems is ROADMAP Queue 1 item 8")

        # Weight initialization and the loop, at one lane (:1326-1457)
        t = self._t
        hyp = self._hyp(hypers)
        iw_hyp = self._hyp(overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0))
        rzm_t, vmm_t, m_t, l1v_t, lb_t = t(rzm), t(vmm), t(m_stack), t(l1_lambda_vector), t(lb)
        rzv_t = t(rzv)[None]
        est_w, init_w, x_over, out_t = qphb_mod.initialize_weights(
            iw_hyp, m_t, t(rho_vector), t(s_vectors), rzv_t, rzm_t, vmm_t, lb_t, cfg)
        fcfg = fitcore.FitConfig(cfg=cfg, max_iter=max_iter, x_rtol=xtol)
        loop_args = (rzm_t, rzv_t, vmm_t, m_t, l1v_t, lb_t, hyp, t(np.full((1, n), 1e-6)),
                     t(s_vectors)[None], t(rho_vector)[None], t(dop_rho_vector)[None], init_w,
                     est_w, out_t, fcfg)
        if store_history:
            state, history = fitcore.qphb_fit_scan(*loop_args)
            n_hist = int(history["it"][0, -1])
            self.qphb_history = [{"x": history["x"][0, i],
                                  "s_vectors": history["s_vectors"][0, i],
                                  "rho_vector": history["rho_vector"][0, i],
                                  "dop_rho_vector": history["dop_rho_vector"][0, i],
                                  "weights": history["weights"][0, i],
                                  "outlier_t": history["outlier_t"][0, i],
                                  "converged": bool(history["converged"][0, i])}
                                 for i in range(n_hist)]
        else:
            state = fitcore.qphb_fit_loop(*loop_args)
            self.qphb_history = None

        p_t, q_t = qphb_mod.calculate_pq(rzm_t, rzv_t, m_t, hyp, l1v_t, state.rho_vector,
                                         state.s_vectors, state.weights * weight_factor, cfg)
        npy = lambda a: self._to_numpy(a)[0]
        x = npy(state.x)
        weights = npy(state.weights) * weight_factor
        s_out = npy(state.s_vectors)
        n_iter, converged = int(npy(state.it)), bool(npy(state.converged))
        if not converged and self.warn:
            warnings.warn(f"Solution did not converge within {max_iter} iterations. "
                          "This is usually not an issue.")
        p_matrix, q_vector = npy(p_t), npy(q_t)
        est_weights, init_weights = npy(est_w), npy(init_w)
        self.qphb_params = {
            "est_weights": est_weights, "init_weights": init_weights,
            "weights": weights.copy(), "true_weights": weights.copy(),
            "chrono_weight_factor": 1.0, "eis_weight_factor": 1.0,
            "xmx_norms": npy(state.xmx_norms), "dop_xmx_norms": npy(state.dop_xmx_norms),
            "x_overfit_chrono": None, "x_overfit_eis": npy(x_over),
            "p_matrix": p_matrix, "q_vector": q_vector, "x_raw": x,
            "rho_vector": npy(state.rho_vector), "dop_rho_vector": None,
            "s_vectors": [s_out[k] for k in range(k_range)], "outlier_t": npy(state.outlier_t),
            "vmm": vmm, "l1_lambda_vector": l1_lambda_vector, "rm": rzm, "rv": rzv,
            "penalty_matrices": {f"m{k}": m_stack[k] for k in range(k_range)},
            "hypers": hypers, "num_eis": len(frequencies), "num_chrono": 0,
            "n_iter": n_iter, "converged": converged,
            "vz_strength_vec": np.ones(rzm.shape[0]), "lb": lb, "cfg": cfg,
        }
        self.fit_parameters = self.extract_qphb_parameters(x)
        self.fit_parameters["v_sigma_tot"] = None
        self.fit_parameters["v_sigma_res"] = None
        self.fit_parameters["z_sigma_tot"] = \
            eis_utils.concat_vector_to_complex(weights ** -1) * self.impedance_scale
        self.fit_parameters["vz_offset_eps"] = 1
        self.fit_parameters["p_matrix"] = p_matrix
        self.fit_parameters["q_vector"] = q_vector
        self.fit_type = "qphb_eis"

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self.dtype, device=self.device)

    def _hyp(self, hypers):
        return qphb_mod.hypers_to_tensors(hypers, self.device, self.dtype)

    @staticmethod
    def _to_numpy(a):
        return a.detach().cpu().numpy()

    # ------------------------------------------------------------------
    def fit_eis(self, frequencies, z, nonneg=True, neg_allowed_tau_range=None,
                scale_data=True, update_scale=False, error_structure=None,
                vmm_epsilon=0.25, vmm_reim_cor=0.25, **kwargs):
        """Self-tuning Bayesian DRT fit of an EIS spectrum (:1565)."""
        self._qphb_fit_core(None, None, None, frequencies, z, nonneg=nonneg,
                            neg_allowed_tau_range=neg_allowed_tau_range,
                            scale_data=scale_data, update_scale=update_scale,
                            eis_error_structure=error_structure,
                            eis_vmm_epsilon=vmm_epsilon, eis_reim_cor=vmm_reim_cor, **kwargs)
        return self

    def fit_chrono(self, *args, **kwargs):
        raise _unported("fit_chrono: chrono fits", 6)

    def fit_hybrid(self, *args, **kwargs):
        raise _unported("fit_hybrid: hybrid fits", 6)

    # ------------------------------------------------------------------
    def extract_qphb_parameters(self, x, rescale=True):
        """Physical-unit parameters from a scaled solver vector (:1628)."""
        def scale_value(value, scale):
            return value * scale if rescale else scale

        x = np.asarray(x)
        special = {k: v["index"] for k, v in self.special_qp_params.items()}
        out = {"x": scale_value(x[self.get_qp_mat_offset():], self.coefficient_scale)}
        out["R_inf"] = scale_value(x[special["R_inf"]], self.coefficient_scale) \
            if "R_inf" in special else 0
        out["inductance"] = scale_value(x[special["inductance"]],
                                        self.coefficient_scale * self.inductance_scale) \
            if "inductance" in special else 0
        out["C_inv"] = 0
        return out

    def get_drt_params(self, x=None):
        if x is None:
            x = self.fit_parameters["x"]
        return np.asarray(x)

    def get_tau_eval(self, ppd, extend_decades=0):
        """Evaluation grid spanning basis_tau +- extend_decades (:1893)."""
        log_min = np.log10(np.min(self.basis_tau)) - extend_decades
        log_max = np.log10(np.max(self.basis_tau)) + extend_decades
        return np.logspace(log_min, log_max, int((log_max - log_min) * ppd) + 1)

    def predict_distribution(self, tau=None, ppd=20, order=0, x=None, normalize=False):
        """gamma(ln tau) on an evaluation grid (:1695; order 0)."""
        if tau is None:
            tau = self.get_tau_eval(ppd)
        em = basis_mod.construct_func_eval_matrix(np.log(self.basis_tau),
                                                  np.log(np.asarray(tau, dtype=float)),
                                                  self.tau_basis_type, self.tau_epsilon, order)
        if x is None:
            x = self.fit_parameters["x"]
        else:
            x = np.asarray(x)
            if len(x) > len(self.basis_tau):
                # a raw solver vector: strip the specials and unscale
                x = self.extract_qphb_parameters(x)["x"]
        out = em @ x
        if normalize:
            out = out / self.predict_r_p(absolute=True)
        return out

    def _get_impedance_pred_matrix(self, frequencies):
        """The DRT block's impedance at ``frequencies``: rows of the fit matrix
        where the grid is the fit grid, else a fresh one (:1932)."""
        f = np.asarray(frequencies, dtype=float)
        zm_fit = self.fit_matrices.get("impedance")
        if zm_fit is not None and np.size(self.f_fit) == f.size \
                and np.array_equal(np.asarray(self.f_fit, dtype=float), f):
            return zm_fit
        return impedance_matrix(f, self.basis_tau, self.tau_epsilon)

    def predict_z(self, frequencies=None, x=None, include_drt=True, include_inductance=True,
                  include_ohmic=True, include_cap=True):
        """Predicted impedance (:2004)."""
        if frequencies is None:
            frequencies = self.f_fit
        frequencies = np.asarray(frequencies, dtype=float)
        zm = self._get_impedance_pred_matrix(frequencies)
        if x is not None and not isinstance(x, dict):
            params = self.extract_qphb_parameters(x)
        elif isinstance(x, dict):
            params = x
        else:
            params = self.fit_parameters
        z = np.zeros(len(frequencies), dtype=complex)
        if include_drt:
            z = z + zm @ params["x"]
        if include_ohmic:
            z = z + params.get("R_inf", 0)
        if include_inductance:
            z = z + params.get("inductance", 0) * 2j * np.pi * frequencies
        if include_cap:
            z = z + params.get("C_inv", 0) / (2j * np.pi * frequencies)
        return z

    def predict_r_p(self, absolute=False, x=None, raw=False):
        """Polarization resistance: the DRT coefficients' sum times the basis
        area (:2101)."""
        area = basis_mod.get_basis_func_area(self.tau_basis_type, self.tau_epsilon)
        if raw:
            x = np.asarray(x)
            if len(x) > self.num_drt_params:
                x = x[self.get_qp_mat_offset():]
        else:
            x = self.get_drt_params(x)
        return (np.sum(np.abs(x)) if absolute else np.sum(x)) * area

    def predict_r_inf(self):
        return self.fit_parameters.get("R_inf", 0)

    def predict_r_tot(self):
        return self.predict_r_inf() + self.predict_r_p()
