"""The single-observation DRT (EIS, chrono and hybrid fits) and the EIS
problem assembly it shares with the batched fitter.

Counterpart of ``hybdrt_tpu/models/drt.py`` for the gaussian basis and
``integrate_method="interp"``; chrono data in galvanostatic mode with ideal
steps. The assembly (``process_chrono_signals`` :346, ``scale_data`` :398,
``_prep_for_fit`` :464, ``_prep_chrono_fit_matrix`` :534,
``_prep_impedance_fit_matrix`` :613, ``_prep_penalty_matrices`` :657,
``_format_qp_matrices`` :695, ``_make_lower_bound`` :800) is a set of host
numpy functions in float64, which both ``DRT`` and ``build_eis_problem``
(``BatchedEISFitter``'s problem) call. ``DRT.fit_eis``, ``fit_chrono`` and
``fit_hybrid`` run the port's batched fit loop at B = 1 on its device, with
the design matrix shared as in ``BatchedEISFitter``: on the card, their QPs
launch the lane kernels at one lane.

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
from ..utils import chrono as chrono_utils
from ..utils import eis as eis_utils
from ..utils import validation
from ..utils.device import resolve_device
from .background import get_baseline_matrix

# Keywords of the JAX ``_qphb_fit_core`` (hybdrt_tpu/models/drt.py:870-894)
# whose code is not ported (downsampling, the GP background), with their
# defaults: the port takes them only to refuse another value
CHRONO_KW = {"downsample": False, "downsample_kw": None, "subtract_background": False,
             "background_type": "static", "background_corr_power": None,
             "estimate_background_kw": None, "background_penalty": 1}


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


def eis_basis_tau(frequencies, fixed_basis_tau=None, tau_supergrid=None, extend_decades=1,
                  times=None, step_times=None):
    """``fixed_basis_tau``, else the slice of ``tau_supergrid`` that covers the
    data range +- extend_decades, else a 10-ppd grid over it (:476-481); the
    data range takes in the chrono times since each step where given."""
    if fixed_basis_tau is not None:
        return np.asarray(fixed_basis_tau, dtype=float)
    return pp.get_basis_tau(frequencies, times, step_times, extend_decades=extend_decades,
                            tau_grid=tau_supergrid)


def special_qp_params(fit_ohmic=True, fit_inductance=True, v_baseline_size=0, vz_offset=False):
    """The special columns before the DRT block, in the JAX package's order
    (:1052-1064): the chrono voltage baseline's ``v_baseline_size`` columns,
    the hybrid vz offset, R_inf and the inductance."""
    special = {}
    for name, size, nonneg in (("v_baseline", v_baseline_size, False),
                               ("vz_offset", int(vz_offset), False),
                               ("R_inf", int(fit_ohmic), True),
                               ("inductance", int(fit_inductance), True)):
        if size:
            special[name] = {"index": num_special(special), "nonneg": nonneg, "size": size}
    return special


def num_special(special):
    """The number of special columns."""
    return int(sum(sp.get("size", 1) for sp in special.values()))


def special_slice(special, name):
    sp = special[name]
    return slice(sp["index"], sp["index"] + sp.get("size", 1))


def impedance_matrix(frequencies, basis_tau, tau_epsilon):
    """Complex (F, n_tau) matrix of the DRT block's impedance (:629-637)."""
    zre_lu, zim_lu = lookup.generate_impedance_lookup("gaussian", float(tau_epsilon))
    return mat1d.construct_impedance_matrix(frequencies, "real", basis_tau,
                                            epsilon=tau_epsilon, interpolate_grids=zre_lu) \
        + 1j * mat1d.construct_impedance_matrix(frequencies, "imag", basis_tau,
                                                epsilon=tau_epsilon, interpolate_grids=zim_lu)


def eis_design_matrix(zm_drt, frequencies, special, inductance_scale):
    """The impedance matrix with its special columns, stacked [Re; Im]
    (2F, N) (:746-758); the baseline and vz-offset columns are zero."""
    ns = num_special(special)
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


def chrono_design_matrix(rm_drt, special, vb_mat, induc_rv, inf_rv, inductance_scale):
    """The response matrix with its special columns (T, N) (:719-739): the
    normalized baseline matrix ``vb_mat``, the inductance and ohmic
    response vectors; the vz-offset column is zero."""
    ns = num_special(special)
    rm = np.empty((rm_drt.shape[0], rm_drt.shape[1] + ns))
    if "v_baseline" in special:
        rm[:, special_slice(special, "v_baseline")] = vb_mat
    if "inductance" in special:
        rm[:, special["inductance"]["index"]] = induc_rv * inductance_scale
    if "R_inf" in special:
        rm[:, special["R_inf"]["index"]] = inf_rv
    if "vz_offset" in special:
        rm[:, special["vz_offset"]["index"]] = 0
    rm[:, ns:] = rm_drt
    return rm


def penalty_stack(base, special, penalties):
    """(3, N, N): each order's DRT block with the special columns' diagonal
    penalties ``penalties[name]`` before it, a scalar or one value per
    column (:762-794)."""
    ns = num_special(special)
    n = base.shape[-1] + ns
    m_stack = np.zeros((3, n, n))
    for k in range(3):
        m_stack[k, ns:, ns:] = base[k]
        for name, sp in special.items():
            pen = penalties[name]
            for j, i in enumerate(range(sp["index"], sp["index"] + sp.get("size", 1))):
                m_stack[k, i, i] = pen if np.isscalar(pen) else pen[j]
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
    ns = num_special(special)
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
# The single-observation DRT (hybdrt_tpu/models/drt.py:33)
# ---------------------------------------------------------------------------
class DRT:
    """Distribution of relaxation times fitted to one EIS spectrum, one
    chrono record or both (hybrid) by the self-tuning QPHB loop.

    Usage:
        drt = DRT()                      # on the CUDA card, float64
        drt.fit_eis(freq, z)
        drt.fit_chrono(times, i_signal, v_signal)
        drt.fit_hybrid(times, i_signal, v_signal, freq, z)
        drt.fit_parameters["x"], drt.predict_r_p(), drt.predict_z(freq),
        drt.predict_response(times)

    ``device=None`` means the card (``RuntimeError`` where none is present;
    ``device="cpu"`` runs on the CPU). ``dtype`` is the fit's, float64 by
    default as the JAX ``DRT`` (``hybdrt_tpu/__init__.py:27``); the assembly
    is host float64 either way. Chrono data are galvanostatic with ideal
    steps (ROADMAP Queue 1 item 11).
    """

    def __init__(self, fixed_basis_tau=None, tau_supergrid=None, tau_basis_type="gaussian",
                 basis_tau_ppd=10, extend_basis_decades=1, step_model="ideal",
                 chrono_mode="galv", interpolate_integrals=True, fit_dop=False,
                 fit_inductance=True, fit_ohmic=True, fit_capacitance=False, warn=True,
                 device=None, dtype=torch.float64):
        validation.check_basis_type(tau_basis_type)
        validation.check_step_model(step_model)
        validation.check_ctrl_mode(chrono_mode)
        if tau_basis_type != "gaussian":
            raise _unported(f"tau_basis_type={tau_basis_type!r}: bases other than gaussian", 4)
        if not interpolate_integrals:
            raise _unported("interpolate_integrals=False (integrate_method='trapz')", 4)
        if fit_dop:
            raise _unported("fit_dop: the distribution of phasances", 4)
        if fit_capacitance:
            raise _unported("fit_capacitance: the capacitance column", 4)
        if step_model != "ideal":
            raise _unported(f"step_model={step_model!r}: non-ideal steps", 11)
        if chrono_mode != "galv":
            raise _unported(f"chrono_mode={chrono_mode!r}: potentiostatic chrono data", 11)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fixed_basis_tau = None if fixed_basis_tau is None else np.asarray(fixed_basis_tau)
        self.tau_supergrid = None if tau_supergrid is None else np.asarray(tau_supergrid)
        self.basis_tau = None
        self.tau_basis_type = tau_basis_type
        self.extend_basis_decades = extend_basis_decades
        self.step_model = step_model
        self.chrono_mode = chrono_mode
        self.integrate_method = "interp"
        self.fit_inductance = fit_inductance
        self.fit_ohmic = fit_ohmic
        self.warn = warn
        self.tau_epsilon = default_tau_epsilon(self.fixed_basis_tau, self.tau_supergrid,
                                               basis_tau_ppd)

        # chrono state
        self.t_fit = []
        self.step_times = None
        self.step_sizes = None
        self.tau_rise = None
        self.nonconsec_step_times = None
        self.sample_index = None
        self.raw_input_signal = None
        self.raw_response_signal = None
        self.raw_response_background = None
        self.scaled_input_signal = None
        self.scaled_response_signal = None
        self.scaled_response_offset = None
        self.input_signal_scale = None
        self.response_signal_scale = None
        self.v_baseline_deg = None
        self.v_baseline_sqrt = None
        self.v_baseline_scale = None
        # EIS state
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
        self._fit_rm_signature = None
        self._pred_mat_cache = {}

    # ------------------------------------------------------------------
    def get_qp_mat_offset(self):
        return num_special(self.special_qp_params)

    def get_special_indices(self, name):
        s = special_slice(self.special_qp_params, name)
        return s.start, s.stop

    @property
    def num_drt_params(self):
        return len(self.basis_tau)

    def get_fit_frequencies(self, return_none=False):
        if len(np.atleast_1d(self.f_fit)) == 0:
            return None if return_none else np.array([])
        return np.asarray(self.f_fit)

    def get_fit_times(self, return_none=False):
        if self.t_fit is None or len(np.atleast_1d(self.t_fit)) == 0:
            return None if return_none else np.array([])
        return np.asarray(self.t_fit)

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

    # ------------------------------------------------------------------
    # Chrono signals and data scale
    # ------------------------------------------------------------------
    def process_chrono_signals(self, times, i_signal, v_signal, step_times, step_sizes,
                               offset_steps, step_offset_size):
        """Steps of the input signal, the nonconsecutive step times and the
        fit samples (every sample: downsampling is not ported) (:346)."""
        if times is None:
            self.step_times = None
            self.step_sizes = None
            self.tau_rise = None
            return None, None, None, None, None, None

        input_signal = i_signal if self.chrono_mode == "galv" else v_signal
        if step_times is None:
            step_times, step_sizes, tau_rise = pp.process_input_signal(
                times, input_signal, self.step_model, offset_steps, offset_size=step_offset_size)
        else:
            if step_sizes is None:
                step_sizes = pp.get_step_sizes(times, input_signal, step_times)
            tau_rise = None
        step_times = np.atleast_1d(np.asarray(step_times, dtype=float))
        step_sizes = np.atleast_1d(np.asarray(step_sizes, dtype=float))
        if len(step_times) == 0:
            raise ValueError("no step was found in the input signal")

        if len(step_times) > 1:
            step_diff = np.diff(step_times)
            t_sample = np.min(np.diff(times))
            nonconsec = step_times[1:][step_diff > 1.1 * t_sample]
            self.nonconsec_step_times = np.insert(nonconsec, 0, step_times[0])
        else:
            self.nonconsec_step_times = np.asarray(step_times)

        self.sample_index = np.arange(len(times), dtype=int)
        sample_times = np.array(times, dtype=float)
        sample_i = np.array(i_signal, dtype=float)
        sample_v = np.array(v_signal, dtype=float)
        self.t_fit = sample_times
        input_signal, response_signal = chrono_utils.get_input_and_response(
            sample_i, sample_v, self.chrono_mode)
        self.raw_input_signal = input_signal.copy()
        self.raw_response_signal = response_signal.copy()
        self.step_times = step_times.copy()
        self.step_sizes = step_sizes.copy()
        self.tau_rise = tau_rise
        return sample_times, sample_i, sample_v, step_times, step_sizes, tau_rise

    def scale_data(self, times, i_signal, v_signal, step_times, step_sizes, z, apply_scaling,
                   rp_scale):
        """The coefficient scale rp_est / rp_scale, and the scaled signals
        and spectrum (:398): the input divided by its largest step, the
        response by that times the coefficient scale."""
        if apply_scaling:
            _, response_signal = chrono_utils.get_input_and_response(i_signal, v_signal,
                                                                     self.chrono_mode)
            rp_est = pp.estimate_rp(times, step_times, step_sizes, response_signal,
                                    self.step_model, z)
            self.coefficient_scale = rp_est / rp_scale
        else:
            rp_est = 1.0
            self.coefficient_scale = 1.0

        if times is not None:
            if apply_scaling:
                self.input_signal_scale = np.max(np.abs(step_sizes))
                self.response_signal_scale = self.input_signal_scale * rp_est / rp_scale
            else:
                self.input_signal_scale = 1.0
                self.response_signal_scale = 1.0
            self.scaled_input_signal = self.raw_input_signal / self.input_signal_scale
            self.scaled_response_signal = self.raw_response_signal / self.response_signal_scale
            scaled_i = self.scaled_input_signal.copy()
            scaled_v = self.scaled_response_signal.copy()
        else:
            scaled_i, scaled_v = None, None
            self.input_signal_scale = None
            self.response_signal_scale = None
            self.raw_input_signal = None
            self.raw_response_signal = None
            self.scaled_input_signal = None
            self.scaled_response_signal = None

        if z is not None:
            self.impedance_scale = self.coefficient_scale
            z_scaled = z / self.impedance_scale
            self.z_fit = z.copy()
            self.z_fit_scaled = z_scaled.copy()
        else:
            z_scaled = None
            self.z_fit = None
            self.z_fit_scaled = None
        return scaled_i, scaled_v, z_scaled

    def update_data_scale(self, factor):
        """Rescale the data by ``factor`` (galvanostatic mode) (:446)."""
        if self.scaled_response_signal is not None:
            self.response_signal_scale /= factor
            self.scaled_response_offset *= factor
            self.scaled_response_signal *= factor
        if self.z_fit_scaled is not None:
            self.z_fit_scaled = self.z_fit_scaled * factor
        self.coefficient_scale /= factor
        self.impedance_scale /= factor

    # ------------------------------------------------------------------
    # Matrices
    # ------------------------------------------------------------------
    def _prep_chrono_fit_matrix(self, times, step_times, step_sizes, tau_rise,
                                smooth_inf_response):
        """(rm_drt, inf_rv, induc_rv) of the fit samples, cached by
        protocol (:534)."""
        key = ("rm", self._basis_signature(), self.step_model, self.chrono_mode,
               np.asarray(times).tobytes(), np.atleast_1d(step_times).astype(float).tobytes(),
               np.atleast_1d(step_sizes).astype(float).tobytes(),
               np.asarray(self.raw_input_signal).tobytes(), bool(smooth_inf_response))

        def build():
            rm, rm_layered = mat1d.construct_response_matrix(
                self.basis_tau, times, self.step_model, step_times, step_sizes,
                basis_type=self.tau_basis_type, epsilon=self.tau_epsilon, tau_rise=tau_rise,
                op_mode=self.chrono_mode, integrate_method=self.integrate_method,
                interpolate_grids=lookup.generate_response_lookup(
                    self.tau_basis_type, self.chrono_mode, self.step_model,
                    float(self.tau_epsilon)))
            induc_rv = mat1d.construct_inductance_response_vector(
                times, self.step_model, step_times, step_sizes, tau_rise, self.chrono_mode)
            inf_rv = mat1d.construct_ohmic_response_vector(
                times, self.step_model, step_times, step_sizes, tau_rise, self.raw_input_signal,
                smooth_inf_response, self.chrono_mode)
            return rm, rm_layered, induc_rv, inf_rv

        rm, rm_layered, induc_rv, inf_rv = self._cached(key, build)
        self.fit_matrices["response"] = rm
        self.fit_matrices["rm_layered"] = rm_layered
        self.fit_matrices["inductance_response"] = induc_rv
        self.fit_matrices["inf_response"] = inf_rv
        self._fit_rm_signature = self._response_signature(step_times, step_sizes)
        return rm, inf_rv, induc_rv

    def _response_signature(self, step_times, step_sizes):
        return self._basis_signature() + (
            self.step_model, self.chrono_mode,
            tuple(np.round(np.atleast_1d(step_times).astype(float), 12).tolist()),
            tuple(np.round(np.atleast_1d(step_sizes).astype(float), 12).tolist()))

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

    def _get_vz_strength_vec(self, times=None, frequencies=None, fit_times=None,
                             step_times=None, fit_frequencies=None, vz_offset_eps=1):
        """The vz offset's coupling strength (chrono rows, EIS rows): 1 where
        the chrono and EIS time scales overlap, a gaussian decay in log time
        outside, 0 before the first step (:826)."""
        if fit_times is None:
            fit_times = self.get_fit_times(True)
        if step_times is None:
            step_times = self.nonconsec_step_times
        if fit_frequencies is None:
            fit_frequencies = self.get_fit_frequencies(True)

        if fit_times is None or fit_frequencies is None or vz_offset_eps is None:
            chrono_s = np.ones(len(times)) if times is not None else None
            eis_s = np.ones(len(frequencies)) if frequencies is not None else None
            return chrono_s, eis_s

        def rbf(y, eps):
            return np.exp(-(eps * y) ** 2)

        fit_td = pp.get_time_since_step(fit_times, step_times, prestep_value=-1)
        chrono_tau_min = np.min(fit_td[fit_td > 0])
        eis_tau_max = np.max(1 / (2 * np.pi * fit_frequencies))

        chrono_s = eis_s = None
        if times is not None:
            td = pp.get_time_since_step(times, step_times, prestep_value=-1)
            chrono_s = np.ones(len(td))
            mask = td >= eis_tau_max
            chrono_s[mask] = rbf(np.log(td[mask] / eis_tau_max), vz_offset_eps)
            chrono_s[td == -1] = 0
        if frequencies is not None:
            f_inv = 1 / (2 * np.pi * frequencies)
            eis_s = np.ones(len(frequencies))
            mask = f_inv <= chrono_tau_min
            eis_s[mask] = rbf(np.log(f_inv[mask] / chrono_tau_min), vz_offset_eps)
        return chrono_s, eis_s

    # ------------------------------------------------------------------
    # The fit
    # ------------------------------------------------------------------
    def _qphb_fit_core(self, times, i_signal, v_signal, frequencies, z, step_times=None,
                       step_sizes=None, nonneg=True, neg_allowed_tau_range=None, series_neg=False,
                       scale_data=True, update_scale=False, solve_rp=False, offset_steps=True,
                       step_offset_size=None, offset_baseline=True, v_baseline_deg=0,
                       v_baseline_sqrt=False, smooth_inf_response=True, v_baseline_penalty=1e-6,
                       ohmic_penalty=1e-6, inductance_penalty=1e-6, inductance_scale=1e-5,
                       capacitance_scale=1e-3, remove_extremes=False, extreme_kw=None,
                       init_weights_separately=False, chrono_error_structure="uniform",
                       eis_error_structure=None, remove_outliers=False,
                       return_outlier_index=False, chrono_vmm_epsilon=4, eis_vmm_epsilon=0.25,
                       eis_reim_cor=0.25, iw_l1_lambda_0=1e-4, iw_l2_lambda_0=1e-4,
                       vz_offset=True, vz_offset_scale=1, vz_offset_eps=1,
                       eis_weight_factor=None, chrono_weight_factor=None,
                       hybrid_weight_factor_method=None, eff_hp=True, weight_factor=1, xtol=1e-2,
                       max_iter=50, store_history=False, prep_only=False, **kw):
        """The fit of EIS, chrono or hybrid data (``hybdrt_tpu/models/drt.py:870``).
        ``prep_only=True`` returns the assembled system as the JAX dict
        (:1293-1324), numpy arrays, without fitting."""
        validation.check_chrono_data(times, i_signal, v_signal)
        validation.check_eis_data(frequencies, z)
        for err_struct in (chrono_error_structure, eis_error_structure):
            validation.check_error_structure(err_struct)
        unported = [k for k, default in CHRONO_KW.items() if k in kw and kw.pop(k) != default]
        if unported:
            raise _unported(f"{unported}: downsampling and background subtraction", 11)
        if remove_outliers or return_outlier_index:
            raise _unported("remove_outliers / return_outlier_index: the outlier model", 9)
        if times is None and frequencies is None:
            raise ValueError("no data: give chrono data (times, i_signal, v_signal), EIS data "
                             "(frequencies, z) or both")
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
        self.v_baseline_deg = v_baseline_deg
        self.v_baseline_sqrt = v_baseline_sqrt

        if times is not None:
            times = np.array(times, dtype=float)
            i_signal = np.array(i_signal, dtype=float)
            v_signal = np.array(v_signal, dtype=float)
        if frequencies is not None:
            frequencies = np.array(frequencies, dtype=float)
            z = np.array(z, dtype=complex)
        if remove_extremes:
            if extreme_kw is None:
                extreme_kw = {"qr_size": 0.8, "qr_thresh": 1.5}
            if times is not None:
                flag = pp.identify_extreme_values(i_signal, **extreme_kw) | \
                    pp.identify_extreme_values(v_signal, **extreme_kw)
                if flag.any():
                    if self.warn:
                        warnings.warn(f"Removing extreme chrono values at indices "
                                      f"{np.where(flag)[0].tolist()}")
                    times, i_signal, v_signal = times[~flag], i_signal[~flag], v_signal[~flag]
            if frequencies is not None:
                flag = pp.identify_extreme_values(z.real, **extreme_kw) | \
                    pp.identify_extreme_values(z.imag, **extreme_kw)
                if flag.any():
                    if self.warn:
                        warnings.warn(f"Removing extreme EIS values at indices "
                                      f"{np.where(flag)[0].tolist()}")
                    frequencies, z = frequencies[~flag], z[~flag]

        data_type = "eis" if times is None else ("chrono" if frequencies is None else "hybrid")
        num_eis = 0 if frequencies is None else len(frequencies)
        fit_vz = bool(vz_offset and data_type == "hybrid")
        self.special_qp_params = special_qp_params(
            self.fit_ohmic, self.fit_inductance, vz_offset=fit_vz,
            v_baseline_size=0 if times is None else v_baseline_deg + 1 + int(v_baseline_sqrt))
        sp = self.special_qp_params
        ns = self.get_qp_mat_offset()

        # _prep_for_fit (:464): chrono processing, basis, matrices, data scale
        sample_times, sample_i, sample_v, step_times, step_sizes, tau_rise = \
            self.process_chrono_signals(times, i_signal, v_signal, step_times, step_sizes,
                                        offset_steps, step_offset_size)
        self.basis_tau = eis_basis_tau(frequencies, self.fixed_basis_tau, self.tau_supergrid,
                                       self.extend_basis_decades, times=times,
                                       step_times=step_times)
        if self.tau_epsilon is None:
            self.tau_epsilon = 1 / np.mean(np.diff(np.log(self.basis_tau)))
        if sample_times is not None:
            rm_drt, inf_rv, induc_rv = self._prep_chrono_fit_matrix(
                sample_times, step_times, step_sizes, tau_rise, smooth_inf_response)
        else:
            self.t_fit = []
        zm_drt = None
        if frequencies is not None:
            zm_drt = self._prep_impedance_fit_matrix(frequencies)
        else:
            self.f_fit = []
        base_penalty = self._prep_penalty_matrices()
        _, v_scaled, z_scaled = self.scale_data(sample_times, sample_i, sample_v, step_times,
                                                step_sizes, z, scale_data, hypers["rp_scale"])
        num_chrono = 0
        if sample_times is not None:
            num_chrono = len(sample_times)
            response_baseline = np.median(v_scaled[sample_times < step_times[0]])
            rm_drt = rm_drt / self.input_signal_scale
            induc_rv = induc_rv / self.input_signal_scale
            inf_rv = inf_rv / self.input_signal_scale

        # _format_qp_matrices (:695)
        neg_allowed_indices = self._get_neg_allowed_indices(nonneg, neg_allowed_tau_range)
        self.inductance_scale = inductance_scale
        rm = zm = None
        if sample_times is not None:
            vb_mat = None
            if "v_baseline" in sp:
                vb_mat, self.v_baseline_scale = get_baseline_matrix(
                    self.get_fit_times(), v_baseline_deg, normalize=True, sqrt=v_baseline_sqrt)
            rm = chrono_design_matrix(rm_drt, sp, vb_mat, induc_rv, inf_rv, inductance_scale)
        if zm_drt is not None:
            zm = eis_design_matrix(zm_drt, frequencies, sp, inductance_scale)
        m_stack = penalty_stack(base_penalty, sp, {
            "v_baseline": v_baseline_penalty, "vz_offset": 1 / vz_offset_scale,
            "R_inf": ohmic_penalty, "inductance": inductance_penalty})
        rzm = zm if rm is None else (rm if zm is None else np.vstack((rm, zm)))

        # vz offset (:1138-1153)
        if fit_vz:
            rzm_vz = rzm.copy()
            rzm_vz[:, special_slice(sp, "v_baseline")] = 0
            chrono_vz, eis_vz = self._get_vz_strength_vec(
                sample_times, frequencies, fit_times=sample_times, fit_frequencies=frequencies,
                vz_offset_eps=vz_offset_eps)
            vz_strength_vec = np.concatenate([chrono_vz, np.tile(eis_vz, 2)])
        else:
            rzm_vz = np.zeros_like(rzm)
            vz_strength_vec = np.ones(rzm.shape[0])

        # The data vector with the response's baseline offset (:1155-1173)
        rv = zv = None
        if times is not None:
            self.scaled_response_offset = -response_baseline if offset_baseline else 0.0
            rv = self.scaled_response_signal + self.scaled_response_offset
        if frequencies is not None:
            zv = np.concatenate([z_scaled.real, z_scaled.imag])
        rzv = zv.copy() if rv is None else (rv.copy() if zv is None else np.concatenate([rv, zv]))

        n = rzm.shape[1]
        l1_lambda_vector = l1_vector(n, ns, hypers)
        k_range = len(hypers["derivative_weights"])
        rho_vector = np.array(hypers["rho_0"], dtype=float).copy()
        s_vectors = np.stack([np.ones(n) * hypers["s_0"][k] for k in range(k_range)])
        dop_rho_vector = np.ones(k_range)
        cfg = QPHBConfig(num_special=ns, k_range=k_range, eff_hp=eff_hp, has_outlier=False)
        lb = make_lower_bound(n, nonneg, sp, neg_allowed_indices)

        if scale_data and solve_rp:
            # Data-scale refinement from a quick elastic-net solve (:1210-1221)
            x_rp = self._to_numpy(qphb_mod.estimate_x_rp(
                self._hyp(hypers), self._t(m_stack), self._t(rho_vector), self._t(s_vectors),
                self._t(rzv)[None], self._t(rzm), self._t(lb), cfg))[0]
            rp_est = self.predict_r_p(absolute=True, x=x_rp, raw=True)
            scale_factor = hypers["rp_scale"] / rp_est
            for vec in (rv, zv, rzv):
                if vec is not None:
                    vec *= scale_factor
            self.update_data_scale(scale_factor)

        # The variance-averaging matrices, block diagonal for hybrid data
        chrono_vmm = eis_vmm = None
        if times is not None:
            nst = np.atleast_1d(self.nonconsec_step_times)
            chrono_vmm = self._cached(
                ("vmm_c", sample_times.tobytes(), nst.tobytes(), float(chrono_vmm_epsilon),
                 chrono_error_structure),
                lambda: mat1d.construct_chrono_var_matrix(sample_times, nst, chrono_vmm_epsilon,
                                                          chrono_error_structure))
        if frequencies is not None:
            eis_vmm = self._cached(("vmm_e", frequencies.tobytes(), float(eis_vmm_epsilon),
                                    float(eis_reim_cor), eis_error_structure),
                                   lambda: mat1d.construct_eis_var_matrix(
                                       frequencies, eis_vmm_epsilon, eis_reim_cor,
                                       eis_error_structure))
        if chrono_vmm is None:
            vmm = eis_vmm
        elif eis_vmm is None:
            vmm = chrono_vmm
        else:
            vmm = np.zeros((len(rzv), len(rzv)))
            vmm[:num_chrono, :num_chrono] = chrono_vmm
            vmm[num_chrono:, num_chrono:] = eis_vmm

        vz_index = sp.get("vz_offset", {}).get("index", -1)
        if prep_only:
            return {
                "rzm": rzm, "rzv": rzv, "vmm": vmm, "m_stack": m_stack,
                "l1_lambda_vector": l1_lambda_vector, "lb": lb, "s_vectors": s_vectors,
                "rho_vector": rho_vector, "dop_rho_vector": dop_rho_vector, "cfg": cfg,
                "rzm_vz": rzm_vz, "vz_strength_vec": vz_strength_vec, "vz_offset": fit_vz,
                "vz_index": vz_index, "data_type": data_type, "num_chrono": num_chrono,
                "num_eis": num_eis, "hypers": hypers, "dop_gmat": None,
                "outlier_p": None, "basis_tau": np.asarray(self.basis_tau),
                "special_qp_params": dict(sp), "coefficient_scale": self.coefficient_scale,
                "input_signal_scale": self.input_signal_scale,
                "response_signal_scale": self.response_signal_scale,
                "impedance_scale": self.impedance_scale,
                "v_baseline_scale": self.v_baseline_scale, "dop_scale_vector": None,
                "inductance_scale": inductance_scale, "capacitance_scale": capacitance_scale,
                "sample_times": sample_times, "frequencies": frequencies,
                "hybrid_weight_factor_method": hybrid_weight_factor_method,
                "eis_weight_factor": eis_weight_factor,
                "chrono_weight_factor": chrono_weight_factor, "weight_factor": weight_factor,
                "iw_l1_lambda_0": iw_l1_lambda_0, "iw_l2_lambda_0": iw_l2_lambda_0,
                "scaled_response_offset": self.scaled_response_offset,
            }

        if self.device.type == "cuda" and not chol_lane.admitted(n, self.dtype):
            raise NotImplementedError(
                f"a QP of n={n} parameters in {self.dtype} exceeds the lane kernels' tile rule "
                f"(n <= 268 in float32, 188 in float64, ops/chol_lane.py::admitted); the dense "
                f"path for larger systems is ROADMAP Queue 1 item 8")

        # Weight initialization (:1326-1405), at one lane
        t = self._t
        hyp = self._hyp(hypers)
        iw_hyp = self._hyp(overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0))
        m_t, lb_t = t(m_stack), t(lb)
        npy = lambda a: self._to_numpy(a)[0]

        def init_w(rv_, rm_, vmm_):
            out = qphb_mod.initialize_weights(iw_hyp, m_t, t(rho_vector), t(s_vectors),
                                              t(rv_)[None], t(rm_), t(vmm_), lb_t, cfg)
            return [npy(a) for a in out]

        c_est = c_init = x_over_c = e_est = e_init = x_over_e = None
        if init_weights_separately and data_type == "hybrid":
            c_est, c_init, x_over_c, _ = init_w(rv, rm, chrono_vmm)
            e_est, e_init, x_over_e, _ = init_w(zv, zm, eis_vmm)
        else:
            est, init, x_over, _ = init_w(rzv, rzm, vmm)
            if num_eis == 0:
                c_est, c_init, x_over_c = est, init, x_over
            elif num_chrono == 0:
                e_est, e_init, x_over_e = est, init, x_over
            else:
                # the JAX package splits x_overfit by rows too (:1359)
                c_est, e_est = est[:num_chrono], est[num_chrono:]
                c_init, e_init = init[:num_chrono], init[num_chrono:]
                x_over_c, x_over_e = x_over[:num_chrono], x_over[num_chrono:]
        chrono_weight_scale = None if c_est is None else np.mean(c_est ** -2) ** -0.5
        eis_weight_scale = None if e_est is None else np.mean(e_est ** -2) ** -0.5

        # The hybrid weight factors (:1348-1405)
        if data_type == "hybrid":
            if eis_weight_factor is None or chrono_weight_factor is None:
                if hybrid_weight_factor_method == "weight":
                    ratio = (eis_weight_scale / chrono_weight_scale) ** 0.25
                    if eis_weight_factor is None:
                        eis_weight_factor = 1 / ratio
                    if chrono_weight_factor is None:
                        chrono_weight_factor = ratio
                elif hybrid_weight_factor_method == "rp":
                    rp_eis = pp.estimate_rp(None, None, None, None, None, self.z_fit)
                    rp_chrono = pp.estimate_rp(sample_times, self.step_times, self.step_sizes,
                                               self.raw_response_signal, self.step_model, None)
                    rp_tot = self.coefficient_scale * hypers["rp_scale"]
                    if eis_weight_factor is None:
                        eis_weight_factor = rp_eis ** 0.75 / (rp_chrono ** 0.25 * rp_tot ** 0.5)
                    if chrono_weight_factor is None:
                        chrono_weight_factor = rp_chrono ** 0.75 / (rp_eis ** 0.25
                                                                    * rp_tot ** 0.5)
                elif hybrid_weight_factor_method is None:
                    eis_weight_factor = 1.0
                    chrono_weight_factor = 1.0
                else:
                    raise ValueError(f"Invalid hybrid_weight_factor_method "
                                     f"{hybrid_weight_factor_method}; options: 'weight', "
                                     f"'rp', None")
            est_weights = np.concatenate([c_est, e_est])
            init_weights = np.concatenate([c_init, e_init])
        else:
            eis_weight_factor = chrono_weight_factor = 1.0
            est_weights, init_weights = (e_est, e_init) if data_type == "eis" else (c_est, c_init)

        # The loop (:1407-1457)
        rzm_t, rzv_t, vmm_t, l1v_t = t(rzm), t(rzv)[None], t(vmm), t(l1_lambda_vector)
        fcfg = fitcore.FitConfig(cfg=cfg, data_type=data_type, num_chrono=num_chrono,
                                 vz_offset=fit_vz, vz_index=vz_index, max_iter=max_iter,
                                 x_rtol=xtol)
        row_factors = np.ones(len(rzv))
        row_factors[:num_chrono] = chrono_weight_factor
        row_factors[num_chrono:] = eis_weight_factor
        hybrid = {}
        if data_type == "hybrid":
            hybrid["row_factors"] = t(row_factors)
            if fit_vz:
                hybrid.update(rzm_vz=t(rzm_vz), vz_strength=t(vz_strength_vec))
        loop_args = (rzm_t, rzv_t, vmm_t, m_t, l1v_t, lb_t, hyp, t(np.full((1, n), 1e-6)),
                     t(s_vectors)[None], t(rho_vector)[None], t(dop_rho_vector)[None],
                     t(init_weights)[None], t(est_weights)[None], t(np.ones((1, len(rzv)))),
                     fcfg)
        if store_history:
            state, history = fitcore.qphb_fit_scan(*loop_args, **hybrid)
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
            state = fitcore.qphb_fit_loop(*loop_args, **hybrid)
            self.qphb_history = None

        if fit_vz:
            # The design as the loop left it: the vz column rewritten from
            # the final iterate
            sys_ = fitcore.LaneSystem(rzm_t, vmm_t, m_t, l1v_t, lb_t, **hybrid,
                                      vz_sign=fitcore.chrono_eis_sign(num_chrono, len(rzv), rzv_t))
            rzm_t = fitcore.with_vz_column(rzm_t, sys_.vz_column(state.x), vz_index)[0]
        x = npy(state.x)
        weights = npy(state.weights)
        scaled_weights = weights.copy()
        if data_type == "hybrid":
            scaled_weights *= row_factors
        s_out = npy(state.s_vectors)
        n_iter, converged = int(npy(state.it)), bool(npy(state.converged))
        if not converged and self.warn:
            warnings.warn(f"Solution did not converge within {max_iter} iterations. "
                          "This is usually not an issue.")
        p_t, q_t = qphb_mod.calculate_pq(rzm_t, rzv_t, m_t, hyp, l1v_t, state.rho_vector,
                                         state.s_vectors, t(scaled_weights)[None], cfg)
        p_matrix, q_vector = npy(p_t), npy(q_t)
        if times is not None and self.raw_response_background is None:
            self.raw_response_background = np.zeros(num_chrono)
        self.qphb_params = {
            "est_weights": est_weights.copy(), "init_weights": init_weights.copy(),
            "weights": scaled_weights.copy(), "true_weights": weights.copy(),
            "chrono_weight_factor": chrono_weight_factor, "eis_weight_factor": eis_weight_factor,
            "xmx_norms": npy(state.xmx_norms), "dop_xmx_norms": npy(state.dop_xmx_norms),
            "x_overfit_chrono": x_over_c, "x_overfit_eis": x_over_e,
            "p_matrix": p_matrix, "q_vector": q_vector, "x_raw": x,
            "rho_vector": npy(state.rho_vector), "dop_rho_vector": None,
            "s_vectors": [s_out[k] for k in range(k_range)], "outlier_t": npy(state.outlier_t),
            "vmm": vmm, "l1_lambda_vector": l1_lambda_vector,
            "rm": self._to_numpy(rzm_t) if fit_vz else rzm, "rv": rzv,
            "penalty_matrices": {f"m{k}": m_stack[k] for k in range(k_range)},
            "hypers": hypers, "num_eis": num_eis, "num_chrono": num_chrono,
            "n_iter": n_iter, "converged": converged,
            "vz_strength_vec": vz_strength_vec, "lb": lb, "cfg": cfg,
        }

        # The noise levels, from the unfactored weights
        sigma_vec = weights ** -1
        v_sigma = z_sigma = None
        if data_type != "eis":
            v_sigma = sigma_vec[:num_chrono] * self.response_signal_scale
        if data_type != "chrono":
            z_sigma = eis_utils.concat_vector_to_complex(sigma_vec[num_chrono:]) \
                * self.impedance_scale
        self.fit_parameters = self.extract_qphb_parameters(x)
        self.fit_parameters["v_sigma_tot"] = v_sigma
        self.fit_parameters["v_sigma_res"] = None
        self.fit_parameters["z_sigma_tot"] = z_sigma
        self.fit_parameters["vz_offset_eps"] = vz_offset_eps
        self.fit_parameters["p_matrix"] = p_matrix
        self.fit_parameters["q_vector"] = q_vector
        self.fit_type = f"qphb_{data_type}"

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

    def fit_chrono(self, times, i_signal, v_signal, step_times=None, step_sizes=None,
                   nonneg=True, neg_allowed_tau_range=None, scale_data=True,
                   update_scale=False, offset_baseline=True, offset_steps=True,
                   step_offset_size=None, downsample=False, downsample_kw=None,
                   subtract_background=False, estimate_background_kw=None,
                   smooth_inf_response=True, error_structure="uniform", vmm_epsilon=4,
                   **kwargs):
        """Self-tuning Bayesian DRT fit of chronopotentiometry data (:1576)."""
        self._qphb_fit_core(times, i_signal, v_signal, None, None, step_times=step_times,
                            step_sizes=step_sizes, nonneg=nonneg,
                            neg_allowed_tau_range=neg_allowed_tau_range,
                            scale_data=scale_data, update_scale=update_scale,
                            offset_steps=offset_steps, step_offset_size=step_offset_size,
                            offset_baseline=offset_baseline, downsample=downsample,
                            downsample_kw=downsample_kw,
                            subtract_background=subtract_background,
                            estimate_background_kw=estimate_background_kw,
                            smooth_inf_response=smooth_inf_response,
                            chrono_error_structure=error_structure,
                            chrono_vmm_epsilon=vmm_epsilon, **kwargs)
        return self

    def fit_hybrid(self, times, i_signal, v_signal, frequencies, z, step_times=None,
                   step_sizes=None, nonneg=True, neg_allowed_tau_range=None, scale_data=True,
                   update_scale=False, offset_steps=True, step_offset_size=None,
                   offset_baseline=True, downsample=False, downsample_kw=None,
                   smooth_inf_response=True, vz_offset=True, vz_offset_scale=1,
                   vz_offset_eps=1, chrono_error_structure="uniform",
                   eis_error_structure=None, chrono_vmm_epsilon=4, eis_vmm_epsilon=0.25,
                   eis_reim_cor=0.25, eis_weight_factor=None, chrono_weight_factor=None,
                   **kwargs):
        """Joint time- and frequency-domain ("hybrid") DRT fit (:1598)."""
        self._qphb_fit_core(times, i_signal, v_signal, frequencies, z, step_times=step_times,
                            step_sizes=step_sizes, nonneg=nonneg,
                            neg_allowed_tau_range=neg_allowed_tau_range,
                            scale_data=scale_data, update_scale=update_scale,
                            offset_steps=offset_steps, step_offset_size=step_offset_size,
                            offset_baseline=offset_baseline, downsample=downsample,
                            downsample_kw=downsample_kw,
                            smooth_inf_response=smooth_inf_response,
                            chrono_error_structure=chrono_error_structure,
                            eis_error_structure=eis_error_structure,
                            chrono_vmm_epsilon=chrono_vmm_epsilon,
                            eis_vmm_epsilon=eis_vmm_epsilon, eis_reim_cor=eis_reim_cor,
                            vz_offset=vz_offset, vz_offset_scale=vz_offset_scale,
                            vz_offset_eps=vz_offset_eps, eis_weight_factor=eis_weight_factor,
                            chrono_weight_factor=chrono_weight_factor, **kwargs)
        return self

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
        if "v_baseline" in special:
            vbx = x[special_slice(self.special_qp_params, "v_baseline")].copy()
            vbx = scale_value(vbx, 1.0 / self.v_baseline_scale)
            vbx[0] -= self.scaled_response_offset
            out["v_baseline"] = scale_value(vbx, self.response_signal_scale)
        if "vz_offset" in special:
            out["vz_offset"] = x[special["vz_offset"]]
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

    @staticmethod
    def _match_indices(x, y, precision=10):
        """Row indices with y[idx] == x elementwise to a relative precision,
        or None where x is not contained in y (:1908)."""
        xr = np.atleast_1d(pp.rel_round(np.asarray(x, dtype=float), precision))
        yr = np.atleast_1d(pp.rel_round(np.asarray(y, dtype=float), precision))
        lookup_ = {v: i for i, v in enumerate(yr)}
        idx = np.empty(len(xr), dtype=int)
        for i, v in enumerate(xr):
            j = lookup_.get(v)
            if j is None:
                return None
            idx[i] = j
        return idx

    def _get_impedance_pred_matrix(self, frequencies):
        """The DRT block's impedance at ``frequencies``: rows of the fit matrix
        where the grid is the fit grid, else a fresh one (:1932)."""
        f = np.asarray(frequencies, dtype=float)
        zm_fit = self.fit_matrices.get("impedance")
        if zm_fit is not None and np.size(self.f_fit) == f.size \
                and np.array_equal(np.asarray(self.f_fit, dtype=float), f):
            return zm_fit
        return impedance_matrix(f, self.basis_tau, self.tau_epsilon)

    def _get_response_pred_matrix(self, times, step_times, step_sizes):
        """The DRT block's step response at ``times``: rows of the fit
        matrix where the protocol is the fit's and the times are among the
        fit times, else a fresh matrix, cached by grid (:1968)."""
        sig = self._response_signature(step_times, step_sizes)
        times = np.asarray(times, dtype=float)
        rm_fit = self.fit_matrices.get("response")
        t_fit = self.get_fit_times()
        if rm_fit is not None and self._fit_rm_signature == sig and np.size(t_fit):
            idx = self._match_indices(times, t_fit)
            if idx is not None:
                return rm_fit[idx]
        entry = self._pred_mat_cache.get("response")
        if entry is not None and entry[0] == sig:
            idx = self._match_indices(times, entry[1])
            if idx is not None:
                return entry[2][idx]
        rm, _ = mat1d.construct_response_matrix(
            self.basis_tau, times, self.step_model, step_times, step_sizes,
            basis_type=self.tau_basis_type, epsilon=self.tau_epsilon, op_mode=self.chrono_mode,
            integrate_method=self.integrate_method,
            interpolate_grids=lookup.generate_response_lookup(
                self.tau_basis_type, self.chrono_mode, self.step_model, float(self.tau_epsilon)))
        self._pred_mat_cache["response"] = (sig, times.copy(), rm)
        return rm

    def _params(self, x):
        if x is None:
            return self.fit_parameters
        return x if isinstance(x, dict) else self.extract_qphb_parameters(x)

    def predict_z(self, frequencies=None, include_vz_offset=True, x=None, include_drt=True,
                  include_inductance=True, include_ohmic=True, include_cap=True):
        """Predicted impedance (:2004); a hybrid fit's times (1 - vz_offset
        times its coupling strength)."""
        if frequencies is None:
            frequencies = self.get_fit_frequencies()
        frequencies = np.asarray(frequencies, dtype=float)
        zm = self._get_impedance_pred_matrix(frequencies)
        params = self._params(x)
        z = np.zeros(len(frequencies), dtype=complex)
        if include_drt:
            z = z + zm @ params["x"]
        if include_ohmic:
            z = z + params.get("R_inf", 0)
        if include_inductance:
            z = z + params.get("inductance", 0) * 2j * np.pi * frequencies
        if include_cap:
            z = z + params.get("C_inv", 0) / (2j * np.pi * frequencies)
        if include_vz_offset and "vz_offset" in self.special_qp_params:
            _, vz_strength = self._get_vz_strength_vec(
                None, frequencies, vz_offset_eps=self.fit_parameters.get("vz_offset_eps"))
            z = z * (1 - params.get("vz_offset", 0) * vz_strength)
        return z

    def predict_response(self, times=None, step_times=None, step_sizes=None, x=None,
                         include_vz_offset=True, v_baseline=None):
        """Predicted chrono response (:2044): the DRT's and the ohmic
        resistance's response to the steps, a hybrid fit's times (1 +
        vz_offset times its coupling strength), plus the voltage baseline."""
        if times is None:
            times = self.get_fit_times()
        times = np.asarray(times, dtype=float)
        step_times = self.step_times if step_times is None else step_times
        step_sizes = self.step_sizes if step_sizes is None else step_sizes
        rm = self._get_response_pred_matrix(times, step_times, step_sizes)
        params = self._params(x)
        response = rm @ params["x"]
        inf_rv = mat1d.construct_ohmic_response_vector(
            times, self.step_model, step_times, step_sizes, self.tau_rise,
            pp.generate_model_signal(times, step_times, step_sizes, self.tau_rise,
                                     self.step_model), False, self.chrono_mode)
        response = response + params.get("R_inf", 0) * inf_rv
        if include_vz_offset and "vz_offset" in self.special_qp_params:
            vz_strength, _ = self._get_vz_strength_vec(
                times, None, vz_offset_eps=self.fit_parameters.get("vz_offset_eps"))
            response = response * (1 + params.get("vz_offset", 0) * vz_strength)
        if v_baseline is None:
            v_baseline = params.get("v_baseline", None)
        if v_baseline is not None:
            vb_mat = get_baseline_matrix(times, self.v_baseline_deg, normalize=False,
                                         sqrt=self.v_baseline_sqrt)
            response = response + vb_mat @ np.atleast_1d(v_baseline)
        return response

    def predict_v_baseline(self, times, x_vb=None):
        """The fitted baseline polynomial at ``times`` (:2457)."""
        times = np.asarray(times)
        if "v_baseline" in self.fit_parameters:
            vb_mat = get_baseline_matrix(times, self.v_baseline_deg, normalize=False,
                                         sqrt=self.v_baseline_sqrt)
            if x_vb is None:
                x_vb = np.atleast_1d(self.fit_parameters["v_baseline"])
            return vb_mat @ np.atleast_1d(x_vb)
        return np.zeros_like(times, dtype=float)

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


def build_hybrid_problem(times, i_signal, frequencies, step_times=None, step_sizes=None,
                         basis_tau=None, tau_supergrid=None, fit_ohmic=True, fit_inductance=True,
                         nonneg=True, vz_offset=True, **hyper_kw):
    """Assemble the shared QP problem of hybrid observations on one
    measurement protocol (one time grid, input signal and frequency grid),
    as the JAX ``BatchedHybridFitter`` reads it from a template
    ``DRT.fit_hybrid`` on placeholder data
    (``hybdrt_tpu/parallel/batch.py:1036-1110``). Here the template's
    prep-only system gives the arrays: the template's two iterations change
    none of them but the vz-offset column, which that fitter zeroes.

    The steps are ``get_step_info(times, i_signal)`` (no offset) unless
    given. Returns a dict of host float64 arrays and metadata:
    ``times``, ``i_signal``, ``frequencies``, ``step_times``,
    ``step_sizes``, ``rzm`` (T + 2F, N) with its vz column zero, ``rzm_vz``
    (the baseline columns zeroed too; all zero without ``vz_offset``),
    ``vz_strength_vec``, ``vmm``, ``m_stack``, ``l1v``, ``lb``, ``hypers``,
    ``iw_hypers``, ``cfg``, ``num_chrono``, ``vz_index`` (-1 without
    ``vz_offset``), ``special_qp_params``, ``basis_tau``, ``tau_epsilon``,
    ``inductance_scale``, ``input_signal_scale``, ``rp_scale``."""
    times = np.asarray(times, dtype=float)
    i_signal = np.asarray(i_signal, dtype=float)
    frequencies = np.asarray(frequencies, dtype=float)
    if step_times is None or step_sizes is None:
        step_times, step_sizes = pp.get_step_info(times, i_signal)
    step_times, step_sizes = np.atleast_1d(step_times), np.atleast_1d(step_sizes)
    # Placeholder data consistent with the protocol (:1043-1052)
    z_ph = 1.0 + 1.0 / (1 + 2j * np.pi * frequencies / (2 * np.pi * np.median(frequencies)))
    v_ph = 0.0
    for st, sa in zip(step_times, step_sizes):
        v_ph = v_ph + sa * 2.0 * (1 - np.exp(-np.maximum(times - st, 0) / 1e-3)) * (times >= st)
    template = DRT(fixed_basis_tau=basis_tau, tau_supergrid=tau_supergrid, fit_ohmic=fit_ohmic,
                   fit_inductance=fit_inductance, warn=False, device="cpu")
    sys_ = template._qphb_fit_core(times, i_signal, v_ph, frequencies, z_ph,
                                   step_times=step_times, step_sizes=step_sizes, nonneg=nonneg,
                                   vz_offset=vz_offset, prep_only=True, **hyper_kw)
    hypers = sys_["hypers"]
    return {
        "times": times, "i_signal": i_signal, "frequencies": frequencies,
        "step_times": step_times, "step_sizes": step_sizes, "rzm": sys_["rzm"],
        "rzm_vz": sys_["rzm_vz"], "vz_strength_vec": sys_["vz_strength_vec"],
        "vmm": sys_["vmm"], "m_stack": sys_["m_stack"], "l1v": sys_["l1_lambda_vector"],
        "lb": sys_["lb"], "hypers": hypers, "iw_hypers": overfit_hypers(hypers, 1e-4, 1e-4),
        "cfg": sys_["cfg"], "num_chrono": sys_["num_chrono"], "vz_index": sys_["vz_index"],
        "special_qp_params": sys_["special_qp_params"], "basis_tau": sys_["basis_tau"],
        "tau_epsilon": float(template.tau_epsilon), "inductance_scale": sys_["inductance_scale"],
        "input_signal_scale": sys_["input_signal_scale"],
        "rp_scale": hyper_kw.get("rp_scale", 14.0),
    }
