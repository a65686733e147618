"""The single-observation DRT (EIS, chrono and hybrid fits) and the EIS
problem assembly it shares with the batched fitter.

Counterpart of ``hybdrt_tpu/models/drt.py`` for every tau basis the JAX
package takes (its ``ValueError``s and ``TypeError``s where it raises, at
the same call; ``set_zga_params`` for the ZGA basis) and both
``integrate_method``s, "interp" (``interpolate_integrals=True``) and
"trapz"; chrono data in galvanostatic mode with ideal
or ``expdecay`` steps, downsampled or not, with or without the GP background
(``models/background.py``; static, dynamic and scaled), the ``series_neg``
and ``weight_factor`` options, the capacitance column (``fit_capacitance``,
``C_inv``) and the distribution of phasances (``fit_dop``: the ``x_dop``
block of ``ops/phasance.py``'s basis over nu, gaussian or delta, last among
the special columns). The assembly
(``process_chrono_signals`` :346, ``scale_data`` :398, ``_prep_for_fit`` :464,
``_prep_chrono_fit_matrix`` :534, ``_prep_impedance_fit_matrix`` :613, ``_prep_penalty_matrices`` :657,
``_format_qp_matrices`` :695, ``_make_lower_bound`` :800) is a set of host
numpy functions in float64, which both ``DRT`` and ``build_eis_problem``
(``BatchedEISFitter``'s problem) call. ``DRT.fit_eis``, ``fit_chrono`` and
``fit_hybrid`` run the port's batched fit loop at B = 1 on its device, with
the design matrix shared as in ``BatchedEISFitter``: on the card, their QPs
launch the lane kernels at one lane.

The fitted model is read as the JAX ``DRT`` reads it: predictions, the
Laplace posterior (``estimate_param_cov`` :2168, ``estimate_distribution_cov``
:2319, ``predict_drt_ci`` :2366; the inverse in float64 with ``torch.linalg``
on the fit's device, the rest host numpy), likelihoods and diagnostics
(:2470-2525, :2886-2935) and peaks (:1728-1835, :2525-2560; scipy's
``find_peaks``, ``ndtr`` and ``ndtri`` on the same host arrays). The MAP
samples (``generate_map_samples`` :2197) solve their pinned QPs as one
batched ``ops.qp.solve_qp_box`` call, so that the lane kernels carry them.

Options whose code lies in an unported layer raise ``NotImplementedError``
naming their ROADMAP Queue 1 item.
"""
import warnings
from copy import deepcopy

import numpy as np
import torch
from scipy import signal as sp_signal
from scipy.special import ndtr, ndtri

from .. import evaluation
from .. import peaks as peaks_mod
from .. import preprocessing as pp
from ..ops import basis as basis_mod
from ..ops import lookup, mat1d, phasance
from ..solver import fitcore
from ..solver import hypers as hyp_mod
from ..solver import qphb as qphb_mod
from ..solver.qphb import QPHBConfig
from ..utils import chrono as chrono_utils
from ..utils import eis as eis_utils
from ..utils import validation
from ..utils.array import nearest_index, weighted_quantile_2d
from ..utils.device import resolve_device
from ..utils.stats import bic
from ..mapping import surface
from ..ops import qp as qp_mod
from . import background as bkg_mod
from .background import get_baseline_matrix


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


def special_qp_params(fit_ohmic=True, fit_inductance=True, v_baseline_size=0, vz_offset=False,
                      background_scale=False, fit_capacitance=False, dop_size=0):
    """The special columns before the DRT block, in the JAX package's order
    (:1052-1076): the chrono voltage baseline's ``v_baseline_size`` columns,
    the hybrid vz offset, the scaled background's amplitude, R_inf, the
    inductance, the inverse capacitance and the DOP's ``dop_size``
    coefficients."""
    special = {}
    for name, size, nonneg in (("v_baseline", v_baseline_size, False),
                               ("vz_offset", int(vz_offset), False),
                               ("background_scale", int(background_scale), True),
                               ("R_inf", int(fit_ohmic), True),
                               ("inductance", int(fit_inductance), True),
                               ("C_inv", int(fit_capacitance), True),
                               ("x_dop", dop_size, True)):
        if size:
            special[name] = {"index": num_special(special), "nonneg": nonneg, "size": size}
    return special


def data_offset_parameters(x, special, v_baseline_scale, scaled_response_offset,
                           response_signal_scale):
    """The fitted voltage baseline (physical units) and vz offset of a chrono
    or hybrid fit's scaled solver vector ``x``, the ones its special
    columns hold (:1628); {} for an EIS fit."""
    out = {}
    if "v_baseline" in special:
        vbx = x[special_slice(special, "v_baseline")].copy() * (1.0 / v_baseline_scale)
        vbx[0] -= scaled_response_offset
        out["v_baseline"] = vbx * response_signal_scale
    if "vz_offset" in special:
        out["vz_offset"] = x[special["vz_offset"]["index"]]
    return out


def num_special(special):
    """The number of special columns."""
    return int(sum(sp.get("size", 1) for sp in special.values()))


def special_slice(special, name):
    sp = special[name]
    return slice(sp["index"], sp["index"] + sp.get("size", 1))


ANALYTIC_BASES = ("Cole-Cole", "zga", "delta")


def impedance_lookups(basis_type, tau_epsilon, integrate_method="interp"):
    """The (real, imag) impedance tables of a quadrature basis with
    ``integrate_method="interp"`` (cached by ``lookup``), (None, None) for
    the others (:163-173)."""
    if integrate_method == "interp" and basis_type not in ANALYTIC_BASES:
        return lookup.generate_impedance_lookup(basis_type, float(tau_epsilon))
    return None, None


def impedance_matrix(frequencies, basis_tau, tau_epsilon, basis_type="gaussian",
                     integrate_method="interp", zga_params=None):
    """Complex (F, n_tau) matrix of the DRT block's impedance (:629-637)."""
    zre_lu, zim_lu = impedance_lookups(basis_type, tau_epsilon, integrate_method)
    kw = dict(basis_type=basis_type, epsilon=tau_epsilon, integrate_method=integrate_method,
              zga_params=zga_params)
    return mat1d.construct_impedance_matrix(frequencies, "real", basis_tau,
                                            interpolate_grids=zre_lu, **kw) \
        + 1j * mat1d.construct_impedance_matrix(frequencies, "imag", basis_tau,
                                                interpolate_grids=zim_lu, **kw)


def eis_design_matrix(zm_drt, frequencies, special, inductance_scale, capacitance_scale=None,
                      zm_dop=None, dop_scale_vector=None):
    """The impedance matrix with its special columns, stacked [Re; Im]
    (2F, N) (:746-758): the inductance's, R_inf's, the capacitance's (its
    vector times ``capacitance_scale``) and the DOP block (``zm_dop`` times
    ``dop_scale_vector``); the baseline and vz-offset columns are zero."""
    ns = num_special(special)
    zm = np.zeros((zm_drt.shape[0], zm_drt.shape[1] + ns), dtype=complex)
    if "inductance" in special:
        zm[:, special["inductance"]["index"]] = \
            mat1d.construct_inductance_impedance_vector(frequencies) * inductance_scale
    if "R_inf" in special:
        zm[:, special["R_inf"]["index"]] = 1
    if "C_inv" in special:
        zm[:, special["C_inv"]["index"]] = \
            mat1d.construct_capacitance_impedance_vector(frequencies) * capacitance_scale
    if "x_dop" in special:
        zm[:, special_slice(special, "x_dop")] = zm_dop * dop_scale_vector
    zm[:, ns:] = zm_drt
    return np.vstack([zm.real, zm.imag])


def default_basis_nu(fixed_basis_nu=None):
    """The DOP's nu basis: ``fixed_basis_nu``, else 25 points on [-1, -0.4]
    and 25 on [0.4, 1] (:1067-1072)."""
    if fixed_basis_nu is not None:
        return np.asarray(fixed_basis_nu, dtype=float)
    return np.concatenate([np.linspace(-1, -0.4, 25), np.linspace(0.4, 1, 25)])


def default_nu_epsilon(basis_nu, nu_basis_type="gaussian", nu_epsilon=None):
    """``nu_epsilon``, else one over the nu basis's median spacing; None for
    the delta basis (:1073-1075)."""
    if nu_epsilon is None and nu_basis_type != "delta":
        return 1 / np.median(np.diff(np.sort(basis_nu)))
    return nu_epsilon


def check_nu_basis_type(nu_basis_type):
    """The DOP's nu basis: any basis type the JAX package takes."""
    validation.check_basis_type(nu_basis_type)


def dop_penalty_matrices(basis_nu, nu_basis_type, nu_epsilon):
    """The DOP block's integrated-derivative penalties of orders 0..2 (3, d,
    d): the delta basis's are the gaussian's at epsilon = 1 / its median
    spacing, every other basis's its own (``mat1d``'s generic form for a
    non-gaussian one); and the order-0 smoothing matrix gmat0 (d, d) of its
    s update, gaussian (:675-689)."""
    basis_nu = np.asarray(basis_nu, dtype=float)
    if nu_basis_type == "delta":
        pen_type, eps = "gaussian", 1 / np.median(np.diff(np.sort(basis_nu)))
    else:
        pen_type, eps = nu_basis_type, nu_epsilon
    m_dop = np.stack([mat1d.construct_integrated_derivative_matrix(
        basis_nu, basis_type=pen_type, order=k, epsilon=eps) for k in range(3)])
    dnu = np.mean(np.abs(np.diff(basis_nu)))
    gmat0 = mat1d.construct_integrated_derivative_matrix(basis_nu, basis_type="gaussian",
                                                         order=1, epsilon=1 / dnu)
    return m_dop, gmat0


def dop_gmat_stack(gmat0, k_range=3):
    """(K, d, d): the order-0 smoothing matrix, zeros at the other orders
    (:1202-1207)."""
    return np.stack([gmat0 if k == 0 else np.zeros_like(gmat0) for k in range(k_range)])


def dop_scale_vector(basis_nu, nu_basis_type, nu_epsilon, normalize_dop, tau_eval):
    """The DOP columns' scale (:706-717): ``phasance.phasor_scale_vector``
    over ``tau_eval`` (the supergrid, else the basis), divided by the nu
    basis's area for the gaussian basis; ones without ``normalize_dop``."""
    basis_nu = np.asarray(basis_nu, dtype=float)
    if not normalize_dop:
        return np.ones(len(basis_nu))
    dsv = phasance.phasor_scale_vector(basis_nu, tau_eval)
    if nu_basis_type != "delta":
        dsv = dsv / basis_mod.get_basis_func_area(nu_basis_type, nu_epsilon)
    return dsv


def base_penalty_matrices(basis_tau, tau_epsilon, basis_type="gaussian", zga_params=None):
    """The DRT block's integrated-derivative penalties of orders 0..2,
    (3, n_tau, n_tau) (:668-673)."""
    return np.stack([mat1d.construct_integrated_derivative_matrix(
        np.log(basis_tau), basis_type=basis_type, order=k, epsilon=tau_epsilon,
        zga_params=zga_params) for k in range(3)])


def chrono_design_matrix(rm_drt, special, vb_mat, induc_rv, inf_rv, inductance_scale,
                         cap_rv=None, capacitance_scale=None, rm_dop=None,
                         dop_scale_vector=None):
    """The response matrix with its special columns (T, N) (:719-742): the
    normalized baseline matrix ``vb_mat``, the inductance, ohmic and
    capacitance response vectors and the DOP block (``rm_dop`` times
    ``dop_scale_vector``); the vz-offset and background columns are zero."""
    ns = num_special(special)
    rm = np.empty((rm_drt.shape[0], rm_drt.shape[1] + ns))
    if "v_baseline" in special:
        rm[:, special_slice(special, "v_baseline")] = vb_mat
    if "inductance" in special:
        rm[:, special["inductance"]["index"]] = induc_rv * inductance_scale
    if "R_inf" in special:
        rm[:, special["R_inf"]["index"]] = inf_rv
    if "C_inv" in special:
        rm[:, special["C_inv"]["index"]] = cap_rv * capacitance_scale
    if "x_dop" in special:
        rm[:, special_slice(special, "x_dop")] = rm_dop * dop_scale_vector
    for name in ("vz_offset", "background_scale"):
        if name in special:
            rm[:, special[name]["index"]] = 0
    rm[:, ns:] = rm_drt
    return rm


def penalty_stack(base, special, penalties, dop_base=None):
    """(3, N, N): each order's DRT block with the special columns' diagonal
    penalties ``penalties[name]`` before it, a scalar or one value per
    column, and the DOP block's own penalties ``dop_base`` (3, d, d)
    (:762-794)."""
    ns = num_special(special)
    n = base.shape[-1] + ns
    m_stack = np.zeros((3, n, n))
    for k in range(3):
        m_stack[k, ns:, ns:] = base[k]
        for name, sp in special.items():
            if name == "x_dop":
                m_stack[k, special_slice(special, name), special_slice(special, name)] = \
                    dop_base[k]
                continue
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


def qphb_hypers(eff_hp=True, fit_dop=False, **hyper_kw):
    """The default hyperparameters updated by ``hyper_kw``, each key checked
    (:1081-1085); the outlier model raises (item 9)."""
    hypers = hyp_mod.get_default_hypers(eff_hp=eff_hp, fit_dop=fit_dop)
    for key in hyper_kw:
        if key not in hypers:
            raise ValueError(f"Invalid keyword argument {key}")
    hypers.update(hyper_kw)
    if hypers.get("outlier_p") is not None:
        raise _unported("outlier_p: the outlier model", 9)
    return hypers


def overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0):
    """The weight initialization's hyperparameters (:1330-1336): the DOP
    block's l2 strength scales with the DRT block's."""
    iw_hypers = dict(hypers)
    iw_hypers["l1_lambda_0"] = iw_l1_lambda_0
    iw_hypers["l2_lambda_0"] = iw_l2_lambda_0
    if "dop_l2_lambda_0" in hypers:
        iw_hypers["dop_l2_lambda_0"] = hypers["dop_l2_lambda_0"] / hypers["l2_lambda_0"] \
            * iw_l2_lambda_0
    return iw_hypers


def l1_vector(n, ns, hypers, special=None):
    """The l1 vector: the DRT block's strength, and the DOP block's where
    ``special`` has one (:1175-1180)."""
    l1v = np.zeros(n)
    l1v[ns:] = hypers["l1_lambda_0"]
    if special is not None and "x_dop" in special:
        l1v[special_slice(special, "x_dop")] = hypers["dop_l1_lambda_0"]
    return l1v


def dop_config(special):
    """(dop_start, dop_size) of the QPHBConfig: the DOP block's place among
    the special columns, (0, 0) without one."""
    if "x_dop" not in special:
        return 0, 0
    return special["x_dop"]["index"], special["x_dop"]["size"]


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
    ``fit_capacitance`` adds the C_inv column, ``fit_dop`` the DOP block on
    the default gaussian nu basis (``default_basis_nu``, normalized, as the
    JAX fitter's template has it), with its own penalties and
    hyperparameters.

    Returns a dict of host float64 arrays and metadata: ``frequencies``,
    ``rzm`` (2F, N) design matrix stacked [Re; Im], ``vmm`` (2F, 2F)
    variance-averaging matrix,
    ``m_stack`` (3, N, N) penalty matrices, ``l1v`` (N,), ``lb`` (N,),
    ``hypers`` / ``iw_hypers`` (dicts of floats, arrays and None), ``cfg``,
    ``special_qp_params``, ``basis_tau``, ``tau_epsilon``, ``inductance_scale``,
    ``capacitance_scale``, ``tau_supergrid`` (None without one), and the
    DOP's ``basis_nu``, ``nu_basis_type``, ``nu_epsilon``,
    ``dop_scale_vector`` and ``dop_gmat`` (3, d, d) (None without it).
    """
    if tau_basis_type != "gaussian" or integrate_method != "interp":
        # the JAX fitter's template DRT takes neither option
        raise NotImplementedError(
            f"tau_basis_type={tau_basis_type!r}, integrate_method={integrate_method!r}: the "
            f"batched EIS fitter fits the gaussian basis with 'interp', as the JAX package's "
            f"template fit does (ROADMAP Queue 3 item 27)")

    hypers = qphb_hypers(eff_hp=True, fit_dop=fit_dop, **hyper_kw)
    frequencies = np.asarray(frequencies, dtype=float)
    if tau_supergrid is not None:
        tau_supergrid = np.asarray(tau_supergrid, dtype=float)
    tau_epsilon = default_tau_epsilon(basis_tau, tau_supergrid)
    basis_tau = eis_basis_tau(frequencies, basis_tau, tau_supergrid)

    basis_nu = nu_epsilon = dsv = dop_gmat = dop_base = zm_dop = None
    if fit_dop:
        basis_nu = default_basis_nu()
        nu_epsilon = default_nu_epsilon(basis_nu)
        dop_base, gmat0 = dop_penalty_matrices(basis_nu, "gaussian", nu_epsilon)
        dop_gmat = dop_gmat_stack(gmat0)
        dsv = dop_scale_vector(basis_nu, "gaussian", nu_epsilon, True,
                               tau_supergrid if tau_supergrid is not None else basis_tau)
        zm_dop = phasance.construct_phasor_z_matrix(frequencies, basis_nu, "gaussian",
                                                    nu_epsilon)
    special = special_qp_params(fit_ohmic, fit_inductance, fit_capacitance=fit_capacitance,
                                dop_size=0 if basis_nu is None else len(basis_nu))
    ns = num_special(special)
    n = len(basis_tau) + ns
    inductance_scale = 1e-5
    capacitance_scale = 1e-3
    rzm = eis_design_matrix(impedance_matrix(frequencies, basis_tau, tau_epsilon), frequencies,
                            special, inductance_scale, capacitance_scale, zm_dop, dsv)
    # ohmic, inductance and capacitance penalties 1e-6 (drt.py:879-880)
    m_stack = penalty_stack(base_penalty_matrices(basis_tau, tau_epsilon), special,
                            {name: 1e-6 for name in special}, dop_base)
    vmm = mat1d.construct_eis_var_matrix(frequencies, 0.25, 0.25, None)
    dop_start, dop_size = dop_config(special)
    cfg = QPHBConfig(num_special=ns, dop_start=dop_start, dop_size=dop_size,
                     k_range=len(hypers["derivative_weights"]), eff_hp=True, has_outlier=False)
    return {
        "frequencies": frequencies, "rzm": rzm, "vmm": vmm, "m_stack": m_stack,
        "l1v": l1_vector(n, ns, hypers, special), "lb": make_lower_bound(n, nonneg, special),
        "hypers": hypers, "iw_hypers": overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0),
        "cfg": cfg, "special_qp_params": special, "basis_tau": basis_tau,
        "tau_epsilon": float(tau_epsilon), "inductance_scale": inductance_scale,
        "capacitance_scale": capacitance_scale, "tau_supergrid": tau_supergrid,
        "basis_nu": basis_nu, "nu_basis_type": "gaussian", "nu_epsilon": nu_epsilon,
        "dop_scale_vector": dsv, "dop_gmat": dop_gmat,
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
    is host float64 either way. ``tau_basis_type`` is any of
    ``utils/validation.py``'s, with ``tau_epsilon`` (else from the basis
    grid's spacing; Cole-Cole takes 0.95 only where no grid or ppd gives one,
    ROADMAP Queue 3 item 26). Chrono data are galvanostatic, with ideal or
    ``expdecay`` steps; ``chrono_mode="pot"`` raises the JAX package's own
    ``ValueError``: at construction for a quadrature basis (its response
    integrand is galvanostatic only), at ``fit_chrono`` for the delta basis
    (the ohmic response vector).
    """

    def __init__(self, fixed_basis_tau=None, tau_supergrid=None, tau_basis_type="gaussian",
                 tau_epsilon=None, basis_tau_ppd=10, extend_basis_decades=1, step_model="ideal",
                 chrono_mode="galv", interpolate_integrals=True, chrono_tau_rise=None,
                 fixed_basis_nu=None, nu_basis_type="gaussian", nu_epsilon=None, fit_dop=False,
                 normalize_dop=True, fit_inductance=True, fit_ohmic=True, fit_capacitance=False,
                 warn=True, device=None, dtype=torch.float64):
        validation.check_basis_type(tau_basis_type)
        validation.check_step_model(step_model)
        validation.check_ctrl_mode(chrono_mode)
        check_nu_basis_type(nu_basis_type)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fixed_basis_tau = None if fixed_basis_tau is None else np.asarray(fixed_basis_tau)
        self.tau_supergrid = None if tau_supergrid is None else np.asarray(tau_supergrid)
        self.basis_tau = None
        self.tau_basis_type = tau_basis_type
        self.extend_basis_decades = extend_basis_decades
        self.step_model = step_model
        self.chrono_mode = chrono_mode
        self.chrono_tau_rise = chrono_tau_rise
        self.integrate_method = "interp" if interpolate_integrals else "trapz"
        self.zga_params = None
        self.fit_inductance = fit_inductance
        self.fit_ohmic = fit_ohmic
        self.fit_capacitance = fit_capacitance
        # The distribution of phasances (:73-80)
        self.fixed_basis_nu = None if fixed_basis_nu is None else np.asarray(fixed_basis_nu)
        self.basis_nu = None
        self.nu_epsilon = nu_epsilon
        self.nu_basis_type = nu_basis_type
        self.fit_dop = fit_dop
        self.normalize_dop = normalize_dop
        self.dop_scale_vector = None
        self.warn = warn
        self.tau_epsilon = tau_epsilon
        if tau_epsilon is None:
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
        self.background_gp = None
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
        self.capacitance_scale = None
        self.special_qp_params = {}
        self.fit_parameters = None
        self.fit_type = None
        self.fit_matrices = {}
        self.qphb_params = None
        self.qphb_history = None
        self.pfrt_result = None
        self.map_samples = None
        self.map_sample_kw = None
        self.series_neg = None
        self.fit_kwargs = None
        self._assembly_cache = {}
        self._fit_rm_signature = None
        self._pred_mat_cache = {}
        # the lookup tables of a quadrature basis, built here as in the JAX
        # package (:153-158): a basis or mode they cannot take raises here
        # (the potentiostatic response of any quadrature basis, beta-rbf)
        self.interpolate_lookups

    # ------------------------------------------------------------------
    @property
    def interpolate_lookups(self):
        """{"z_real", "z_imag", "response"}: the lookup tables of the basis
        at the current epsilon (:163-173), None for an analytic basis or
        ``integrate_method="trapz"``; cached by ``lookup``."""
        zre, zim = impedance_lookups(self.tau_basis_type, self.tau_epsilon,
                                     self.integrate_method)
        return {"z_real": zre, "z_imag": zim,
                "response": None if zre is None else self._response_lookup()}

    def get_zga_params(self):
        return self.zga_params

    def set_zga_params(self, value=None, approx_func_epsilon=None, num_bases=7,
                       basis_extent=2, curvature_penalty=None, nonneg=False):
        """The ZGA parameters (:231-249): ``value``, an (x_basis, coef,
        epsilon) tuple, stored as it is; without it the Cole-Cole
        approximation of the gaussian at this model's tau_epsilon
        (``basis.get_basis_approx_params``)."""
        if value is not None:
            self.zga_params = value
            return
        if self.tau_epsilon is None:
            if self.basis_tau is None:
                raise ValueError("Set basis_tau or tau_epsilon before computing ZGA params")
            self.tau_epsilon = 1 / np.mean(np.diff(np.log(self.basis_tau)))
        self.zga_params = basis_mod.get_basis_approx_params(
            "gaussian", "Cole-Cole", self.tau_epsilon, approx_func_epsilon,
            num_bases=num_bases, basis_extent=basis_extent,
            curvature_penalty=curvature_penalty, nonneg=nonneg)

    def get_qp_mat_offset(self):
        return num_special(self.special_qp_params)

    def get_special_indices(self, name):
        s = special_slice(self.special_qp_params, name)
        return s.start, s.stop

    @property
    def dop_indices(self):
        if self.fit_dop and "x_dop" in self.special_qp_params:
            return self.get_special_indices("x_dop")
        return None, None

    @property
    def num_drt_params(self):
        n = len(self.basis_tau)
        return 2 * n if self.series_neg else n

    def get_fit_frequencies(self, return_none=False):
        if len(np.atleast_1d(self.f_fit)) == 0:
            return None if return_none else np.array([])
        return np.asarray(self.f_fit)

    def get_fit_times(self, return_none=False):
        if self.t_fit is None or len(np.atleast_1d(self.t_fit)) == 0:
            return None if return_none else np.array([])
        return np.asarray(self.t_fit)

    @property
    def num_data(self):
        return len(np.atleast_1d(self.get_fit_times())) \
            + 2 * len(np.atleast_1d(self.get_fit_frequencies()))

    def _basis_signature(self):
        """The assembly cache's key of the basis (:1921-1930)."""
        return (self.tau_basis_type, float(self.tau_epsilon),
                np.asarray(self.basis_tau, dtype=float).tobytes(),
                basis_mod.zga_key(self.zga_params), self.integrate_method)

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
                               offset_steps, step_offset_size, downsample=False,
                               downsample_kw=None):
        """Steps of the input signal, the nonconsecutive step times and the
        fit samples: every sample, or with ``downsample`` those of
        ``pp.downsample_data`` (:346-393)."""
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

        if downsample:
            if downsample_kw is None:
                downsample_kw = {"prestep_samples": 10, "target_times": None}
            self.sample_index, (sample_times, sample_i, sample_v) = pp.downsample_data(
                times, i_signal, v_signal, step_times=self.nonconsec_step_times,
                op_mode=self.chrono_mode, **downsample_kw)
        else:
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
               None if tau_rise is None else np.atleast_1d(tau_rise).astype(float).tobytes(),
               np.asarray(self.raw_input_signal).tobytes(), bool(smooth_inf_response))

        def build():
            rm, rm_layered = mat1d.construct_response_matrix(
                self.basis_tau, times, self.step_model, step_times, step_sizes,
                basis_type=self.tau_basis_type, epsilon=self.tau_epsilon, tau_rise=tau_rise,
                op_mode=self.chrono_mode, integrate_method=self.integrate_method,
                zga_params=self.zga_params,
                interpolate_grids=self.interpolate_lookups["response"])
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
        self._fit_rm_signature = self._response_signature(step_times, step_sizes, tau_rise)
        return rm, inf_rv, induc_rv

    def _response_lookup(self):
        """The response table of the constructor's step model and
        ``chrono_tau_rise`` (:163-171; cached by ``lookup``)."""
        tr = self.chrono_tau_rise if self.step_model != "ideal" else None
        return lookup.generate_response_lookup(self.tau_basis_type, self.chrono_mode,
                                               self.step_model, float(self.tau_epsilon),
                                               tau_rise=tr)

    def _response_signature(self, step_times, step_sizes, tau_rise):
        return self._basis_signature() + (
            self.step_model, self.chrono_mode,
            None if tau_rise is None else float(np.atleast_1d(tau_rise)[0]),
            tuple(np.round(np.atleast_1d(step_times).astype(float), 12).tolist()),
            tuple(np.round(np.atleast_1d(step_sizes).astype(float), 12).tolist()))

    def _prep_impedance_fit_matrix(self, frequencies):
        self.f_fit = np.asarray(frequencies)
        zm = self._cached(("zm", self._basis_signature(), self.f_fit.tobytes()),
                          lambda: self._impedance_matrix(frequencies))
        self.fit_matrices["impedance"] = zm
        return zm

    def _impedance_matrix(self, frequencies):
        return impedance_matrix(frequencies, self.basis_tau, self.tau_epsilon,
                                self.tau_basis_type, self.integrate_method, self.zga_params)

    def _prep_penalty_matrices(self):
        base = self._cached(("pen", self._basis_signature()),
                            lambda: base_penalty_matrices(self.basis_tau, self.tau_epsilon,
                                                          self.tau_basis_type, self.zga_params))
        self.fit_matrices.update({f"m{k}": base[k] for k in range(3)})
        return base

    def _nu_signature(self):
        return (self.nu_basis_type, None if self.nu_epsilon is None else float(self.nu_epsilon),
                np.asarray(self.basis_nu, dtype=float).tobytes())

    def _prep_special_matrices(self, times, step_times, step_sizes, tau_rise, frequencies):
        """The capacitance's response vector and the DOP's matrices, each
        built only where fitted (:569-572, :586-594, :645-654, :675-692):
        (cap_rv, rm_dop, zm_dop, m_dop (3, d, d), dop_gmat (3, d, d)), None
        where absent. The JAX ``DRT`` builds the capacitance vector of every
        chrono fit, and so refuses ``expdecay`` steps whether or not the
        capacitance is fitted (ROADMAP Queue 3 item 18); here only a fit with
        ``fit_capacitance`` builds it, and raises that ``ValueError``."""
        cap_rv = rm_dop = zm_dop = m_dop = dop_gmat = None
        if times is not None and self.fit_capacitance:
            cap_rv = mat1d.construct_capacitance_response_vector(
                times, self.step_model, step_times, step_sizes, tau_rise, self.chrono_mode)
            self.fit_matrices["capacitance_response"] = cap_rv
        if not self.fit_dop:
            return cap_rv, rm_dop, zm_dop, m_dop, dop_gmat
        nu_sig = self._nu_signature()
        if times is not None:
            key = ("rm_dop", nu_sig, self.step_model, self.chrono_mode,
                   np.asarray(times).tobytes(), np.atleast_1d(step_times).astype(float).tobytes(),
                   np.atleast_1d(step_sizes).astype(float).tobytes())
            rm_dop = self._cached(key, lambda: phasance.construct_phasor_v_matrix(
                times, self.basis_nu, self.nu_basis_type, self.nu_epsilon, self.step_model,
                step_times, step_sizes, self.chrono_mode)[0])
            self.fit_matrices["rm_dop"] = rm_dop
        if frequencies is not None:
            zm_dop = self._cached(("zm_dop", nu_sig, np.asarray(frequencies).tobytes()),
                                  lambda: phasance.construct_phasor_z_matrix(
                                      frequencies, self.basis_nu, self.nu_basis_type,
                                      self.nu_epsilon))
            self.fit_matrices["zm_dop"] = zm_dop
        m_dop, gmat0 = self._cached(("pen_dop", nu_sig), lambda: dop_penalty_matrices(
            self.basis_nu, self.nu_basis_type, self.nu_epsilon))
        self.fit_matrices.update({f"m{k}_dop": m_dop[k] for k in range(3)})
        self.fit_matrices["gmat0_dop"] = gmat0
        return cap_rv, rm_dop, zm_dop, m_dop, dop_gmat_stack(gmat0)

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
                       ohmic_penalty=1e-6, inductance_penalty=1e-6, capacitance_penalty=1e-6,
                       inductance_scale=1e-5, capacitance_scale=1e-3, downsample=False,
                       downsample_kw=None,
                       subtract_background=False, background_type="static",
                       background_corr_power=None, estimate_background_kw=None,
                       background_penalty=1, remove_extremes=False, extreme_kw=None,
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
        (:1293-1324), numpy arrays, without fitting.

        ``series_neg`` fits nonnegative positive and negative coefficient
        sets side by side (:491-506); ``weight_factor`` scales the data
        weights from the second iteration on; ``subtract_background``
        estimates a GP background from a preliminary fit's residuals
        (``estimate_chrono_background``) and subtracts it ("static"),
        projects it out of the design ("dynamic") or fits its amplitude
        ("scaled") (:991-1029, :1137-1153, :1406-1425)."""
        validation.check_chrono_data(times, i_signal, v_signal)
        validation.check_eis_data(frequencies, z)
        for err_struct in (chrono_error_structure, eis_error_structure):
            validation.check_error_structure(err_struct)
        if remove_outliers or return_outlier_index:
            raise _unported("remove_outliers / return_outlier_index: the outlier model", 9)
        if times is None and frequencies is None:
            raise ValueError("no data: give chrono data (times, i_signal, v_signal), EIS data "
                             "(frequencies, z) or both")
        if series_neg and not nonneg:
            raise ValueError("Only one of series_neg and nonneg may be True")
        if update_scale:
            warnings.warn("update_scale (mid-fit data-scale refinement) is not implemented; "
                          "the scale is set once up front — use solve_rp=True for the refined "
                          "pre-fit Rp estimate instead")
        if self.fit_dop:
            # the nu basis and its epsilon (:1067-1076)
            self.basis_nu = default_basis_nu(self.fixed_basis_nu)
            self.nu_epsilon = default_nu_epsilon(self.basis_nu, self.nu_basis_type,
                                                 self.nu_epsilon)
        else:
            self.basis_nu = None
        hypers = qphb_hypers(eff_hp=eff_hp, fit_dop=self.fit_dop, **kw)
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

        # The GP background from a preliminary fit's residuals (:991-1029)
        bkg = subtract_background and times is not None
        drt_bkg = bkg_gps = None
        self.background_gp = None
        self.raw_response_background = None
        if bkg:
            if background_type not in ("static", "dynamic", "scaled"):
                raise ValueError(f"Invalid background_type {background_type!r}. "
                                 "Options: 'static', 'dynamic', 'scaled'")
            ebk = dict(estimate_background_kw or {})
            ebk.setdefault("nonneg", nonneg)
            drt_bkg, bkg_gps, y_bkg = self.estimate_chrono_background(
                times, i_signal, v_signal, copy_self=True, **ebk)
            self.background_gp = bkg_gps[0]
            y_pred_bkg_full = np.asarray(drt_bkg.predict_response(times))
            if background_corr_power is None and background_type != "static":
                # penalize backgrounds correlated with the model response
                std_ratio = np.std(y_bkg) / np.std(y_pred_bkg_full)
                background_corr_power = np.log(0.02 / std_ratio + 1) + 0.25
            if background_type == "static":
                if background_corr_power is not None:
                    rm_bkg_est = bkg_mod.get_background_matrix(
                        bkg_gps, np.asarray(times)[:, None], y_drt=y_pred_bkg_full,
                        corr_power=background_corr_power)
                    self.raw_response_background = rm_bkg_est @ (
                        np.asarray(v_signal, dtype=float) - y_pred_bkg_full)
                else:
                    self.raw_response_background = np.asarray(y_bkg)
                v_signal = v_signal - self.raw_response_background

        self.fit_kwargs = {"smooth_inf_response": smooth_inf_response,
                           "offset_steps": offset_steps, "step_offset_size": step_offset_size,
                           **hypers, "nonneg": nonneg, "eff_hp": eff_hp,
                           "penalty_type": "integral",
                           "neg_allowed_tau_range": neg_allowed_tau_range}
        self.series_neg = series_neg
        data_type = "eis" if times is None else ("chrono" if frequencies is None else "hybrid")
        num_eis = 0 if frequencies is None else len(frequencies)
        fit_vz = bool(vz_offset and data_type == "hybrid")
        bkg_scaled = bkg and background_type == "scaled"
        self.special_qp_params = special_qp_params(
            self.fit_ohmic, self.fit_inductance, vz_offset=fit_vz, background_scale=bkg_scaled,
            v_baseline_size=0 if times is None else v_baseline_deg + 1 + int(v_baseline_sqrt),
            fit_capacitance=self.fit_capacitance,
            dop_size=0 if self.basis_nu is None else len(self.basis_nu))
        sp = self.special_qp_params
        ns = self.get_qp_mat_offset()

        # _prep_for_fit (:464): chrono processing, basis, matrices, data scale
        sample_times, sample_i, sample_v, step_times, step_sizes, tau_rise = \
            self.process_chrono_signals(times, i_signal, v_signal, step_times, step_sizes,
                                        offset_steps, step_offset_size, downsample,
                                        downsample_kw)
        self.basis_tau = eis_basis_tau(frequencies, self.fixed_basis_tau, self.tau_supergrid,
                                       self.extend_basis_decades, times=times,
                                       step_times=step_times)
        if self.tau_epsilon is None:
            # (:482-486): Cole-Cole's default, the others' from the basis
            if self.tau_basis_type in ("gaussian", "zga"):
                self.tau_epsilon = 1 / np.mean(np.diff(np.log(self.basis_tau)))
            elif self.tau_basis_type == "Cole-Cole":
                self.tau_epsilon = 0.95
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
        cap_rv, rm_dop, zm_dop, dop_base, dop_gmat = self._prep_special_matrices(
            sample_times, step_times, step_sizes, tau_rise, frequencies)
        if series_neg:
            # the negative set: the same columns negated, its own penalty block
            if sample_times is not None:
                rm_drt = np.hstack((rm_drt, -rm_drt))
            if zm_drt is not None:
                zm_drt = np.hstack((zm_drt, -zm_drt))
            base_penalty = np.stack([np.kron(np.eye(2), m) for m in base_penalty])
        _, v_scaled, z_scaled = self.scale_data(sample_times, sample_i, sample_v, step_times,
                                                step_sizes, z, scale_data, hypers["rp_scale"])
        num_chrono = 0
        if sample_times is not None:
            num_chrono = len(sample_times)
            response_baseline = np.median(v_scaled[sample_times < step_times[0]])
            rm_drt = rm_drt / self.input_signal_scale
            induc_rv = induc_rv / self.input_signal_scale
            inf_rv = inf_rv / self.input_signal_scale
            if cap_rv is not None:
                cap_rv = cap_rv / self.input_signal_scale
            if rm_dop is not None:
                rm_dop = rm_dop / self.input_signal_scale

        # _format_qp_matrices (:695)
        neg_allowed_indices = self._get_neg_allowed_indices(nonneg, neg_allowed_tau_range)
        self.inductance_scale = inductance_scale
        self.capacitance_scale = capacitance_scale
        self.dop_scale_vector = None
        if self.fit_dop:
            self.dop_scale_vector = dop_scale_vector(
                self.basis_nu, self.nu_basis_type, self.nu_epsilon, self.normalize_dop,
                self.tau_supergrid if self.tau_supergrid is not None else self.basis_tau)
        rm = zm = None
        if sample_times is not None:
            vb_mat = None
            if "v_baseline" in sp:
                vb_mat, self.v_baseline_scale = get_baseline_matrix(
                    self.get_fit_times(), v_baseline_deg, normalize=True, sqrt=v_baseline_sqrt)
            rm = chrono_design_matrix(rm_drt, sp, vb_mat, induc_rv, inf_rv, inductance_scale,
                                      cap_rv, capacitance_scale, rm_dop, self.dop_scale_vector)
        if zm_drt is not None:
            zm = eis_design_matrix(zm_drt, frequencies, sp, inductance_scale, capacitance_scale,
                                   zm_dop, self.dop_scale_vector)
        m_stack = penalty_stack(base_penalty, sp, {
            "v_baseline": v_baseline_penalty, "vz_offset": 1 / vz_offset_scale,
            "background_scale": background_penalty, "R_inf": ohmic_penalty,
            "inductance": inductance_penalty, "C_inv": capacitance_penalty}, dop_base)

        # The GP background operator of the dynamic and scaled modes
        # (:1114-1128), the dynamic mode's projection out of the design
        rm_bkg = rm_orig = None
        if bkg and background_type != "static":
            rm_bkg = bkg_mod.get_background_matrix(
                bkg_gps, np.asarray(sample_times)[:, None],
                y_drt=np.asarray(drt_bkg.predict_response(sample_times)),
                corr_power=background_corr_power)
            if background_type == "dynamic":
                rm_orig = rm.copy()
                rm = rm - rm_bkg @ rm
        rzm = zm.copy() if rm is None else (rm.copy() if zm is None else np.vstack((rm, zm)))

        # vz offset (:1138-1153); it relates z to the raw voltage, not the
        # background-projected one
        if fit_vz:
            if rm_orig is not None:
                rzm_vz = np.vstack((rm_orig, zm))
            else:
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
        rv = zv = rv_orig = None
        if times is not None:
            self.scaled_response_offset = -response_baseline if offset_baseline else 0.0
            rv = self.scaled_response_signal + self.scaled_response_offset
            if rm_orig is not None:
                rv_orig = rv.copy()
                rv = rv - rm_bkg @ rv
        if frequencies is not None:
            zv = np.concatenate([z_scaled.real, z_scaled.imag])
        rzv = zv.copy() if rv is None else (rv.copy() if zv is None else np.concatenate([rv, zv]))

        n = rzm.shape[1]
        l1_lambda_vector = l1_vector(n, ns, hypers, sp)
        k_range = len(hypers["derivative_weights"])
        rho_vector = np.array(hypers["rho_0"], dtype=float).copy()
        s_vectors = np.stack([np.ones(n) * hypers["s_0"][k] for k in range(k_range)])
        dop_rho_vector = np.array(hypers["dop_rho_0"], dtype=float).copy() if self.fit_dop \
            else np.ones(k_range)
        dop_start, dop_size = dop_config(sp)
        cfg = QPHBConfig(num_special=ns, dop_start=dop_start, dop_size=dop_size, k_range=k_range,
                         eff_hp=eff_hp, has_outlier=False)
        lb = make_lower_bound(n, nonneg, sp, neg_allowed_indices)

        if scale_data and solve_rp:
            # Data-scale refinement from a quick elastic-net solve (:1210-1221)
            x_rp = self._to_numpy(qphb_mod.estimate_x_rp(
                self._hyp(hypers), self._t(m_stack), self._t(rho_vector), self._t(s_vectors),
                self._t(rzv)[None], self._t(rzm), self._t(lb), cfg,
                dop_rho_vector=self._t(dop_rho_vector)))[0]
            rp_est = self.predict_r_p(absolute=True, x=x_rp, raw=True)
            scale_factor = hypers["rp_scale"] / rp_est
            for vec in (rv, zv, rzv, rv_orig):
                if vec is not None:
                    vec *= scale_factor
            self.update_data_scale(scale_factor)
            if self.fit_dop and self.normalize_dop:
                # The DOP columns rescaled to the DRT block's size, in place
                # and in the JAX order (:1222-1231)
                ds_, de_ = dop_start, dop_start + dop_size
                dop_rescale = np.max(np.abs(x_rp[ns:])) / np.max(np.abs(x_rp[ds_:de_]))
                self.dop_scale_vector /= dop_rescale
                for mat in (rm, zm, rzm, rzm_vz, rm_orig):
                    if mat is not None:
                        mat[:, ds_:de_] /= dop_rescale
                for k in range(k_range):
                    m_stack[k][ds_:de_, ds_:de_] /= dop_rescale

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
                "num_eis": num_eis, "hypers": hypers,
                "dop_gmat": None if dop_gmat is None else list(dop_gmat),
                "outlier_p": None, "basis_tau": np.asarray(self.basis_tau),
                "special_qp_params": dict(sp), "coefficient_scale": self.coefficient_scale,
                "input_signal_scale": self.input_signal_scale,
                "response_signal_scale": self.response_signal_scale,
                "impedance_scale": self.impedance_scale,
                "v_baseline_scale": self.v_baseline_scale,
                "dop_scale_vector": self.dop_scale_vector,
                "inductance_scale": inductance_scale, "capacitance_scale": capacitance_scale,
                "sample_times": sample_times, "frequencies": frequencies,
                "hybrid_weight_factor_method": hybrid_weight_factor_method,
                "eis_weight_factor": eis_weight_factor,
                "chrono_weight_factor": chrono_weight_factor, "weight_factor": weight_factor,
                "iw_l1_lambda_0": iw_l1_lambda_0, "iw_l2_lambda_0": iw_l2_lambda_0,
                "scaled_response_offset": self.scaled_response_offset,
            }

        # Weight initialization (:1326-1405), at one lane
        t = self._t
        hyp = self._hyp(hypers)
        iw_hyp = self._hyp(overfit_hypers(hypers, iw_l1_lambda_0, iw_l2_lambda_0))
        m_t, lb_t = t(m_stack), t(lb)
        npy = lambda a: self._to_numpy(a)[0]

        def init_w(rv_, rm_, vmm_):
            out = qphb_mod.initialize_weights(iw_hyp, m_t, t(rho_vector), t(s_vectors),
                                              t(rv_)[None], t(rm_), t(vmm_), lb_t, cfg,
                                              dop_rho_vector=t(dop_rho_vector))
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
                                 x_rtol=xtol, bkg_scaled=bkg_scaled,
                                 bkg_index=sp.get("background_scale", {}).get("index", -1))
        row_factors = np.ones(len(rzv))
        row_factors[:num_chrono] = chrono_weight_factor
        row_factors[num_chrono:] = eis_weight_factor
        hybrid = {}
        if data_type == "hybrid":
            hybrid["row_factors"] = t(row_factors)
            if fit_vz:
                hybrid.update(rzm_vz=t(rzm_vz), vz_strength=t(vz_strength_vec))
        loop_kw = dict(hybrid, weight_factor=weight_factor, return_design=True)
        if bkg_scaled:
            loop_kw["rm_bkg"] = t(rm_bkg)
        if dop_gmat is not None:
            loop_kw["dop_gmat"] = t(dop_gmat)
        loop_args = (rzm_t, rzv_t, vmm_t, m_t, l1v_t, lb_t, hyp, t(np.full((1, n), 1e-6)),
                     t(s_vectors)[None], t(rho_vector)[None], t(dop_rho_vector)[None],
                     t(init_weights)[None], t(est_weights)[None], t(np.ones((1, len(rzv)))),
                     fcfg)
        if store_history:
            state, history, rzm_final = fitcore.qphb_fit_scan(*loop_args, **loop_kw)
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
            state, rzm_final = fitcore.qphb_fit_loop(*loop_args, **loop_kw)
            self.qphb_history = None

        if fit_vz or bkg_scaled:
            # The design as the loop left it: the vz and background columns
            # rewritten from the final iterate
            rzm_t = rzm_final[0]
        x = npy(state.x)
        weights = npy(state.weights) * weight_factor
        scaled_weights = weights.copy()
        if data_type == "hybrid":
            scaled_weights *= row_factors
        s_out = npy(state.s_vectors)
        n_iter, converged = int(npy(state.it)), bool(npy(state.converged))
        if not converged and self.warn:
            warnings.warn(f"Solution did not converge within {max_iter} iterations. "
                          "This is usually not an issue.")
        p_t, q_t = qphb_mod.calculate_pq(rzm_t, rzv_t, m_t, hyp, l1v_t, state.rho_vector,
                                         state.s_vectors, t(scaled_weights)[None], cfg,
                                         dop_rho_vector=state.dop_rho_vector)
        p_matrix, q_vector = npy(p_t), npy(q_t)
        rzm_out = self._to_numpy(rzm_t) if (fit_vz or bkg_scaled) else rzm
        if bkg and background_type != "static":
            # The fitted background (:1406-1425)
            if background_type == "dynamic":
                resid = rv_orig - rm_orig @ x
                self.raw_response_background = (rm_bkg @ resid) * self.response_signal_scale
            else:
                bkg_idx = sp["background_scale"]["index"]
                rzm_resid = rzm_out.copy()
                rzm_resid[:, bkg_idx] = 0
                resid = (rzv - rzm_resid @ x)[:num_chrono]
                self.raw_response_background = (rm_bkg @ resid) * self.response_signal_scale \
                    * x[bkg_idx]
        elif times is not None and self.raw_response_background is None:
            self.raw_response_background = np.zeros(num_chrono)
        self.qphb_params = {
            "est_weights": est_weights.copy(), "init_weights": init_weights.copy(),
            "weights": scaled_weights.copy(), "true_weights": weights.copy(),
            "chrono_weight_factor": chrono_weight_factor, "eis_weight_factor": eis_weight_factor,
            "xmx_norms": npy(state.xmx_norms), "dop_xmx_norms": npy(state.dop_xmx_norms),
            "x_overfit_chrono": x_over_c, "x_overfit_eis": x_over_e,
            "p_matrix": p_matrix, "q_vector": q_vector, "x_raw": x,
            "rho_vector": npy(state.rho_vector),
            "dop_rho_vector": npy(state.dop_rho_vector) if self.fit_dop else None,
            "s_vectors": [s_out[k] for k in range(k_range)], "outlier_t": npy(state.outlier_t),
            "vmm": vmm, "l1_lambda_vector": l1_lambda_vector,
            "rm": rzm_out, "rv": rzv,
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
    def extract_qphb_parameters(self, x):
        """Physical-unit parameters from a scaled solver vector (:1628; the
        reference's ``rescale=True``, the only form the port calls)."""
        x = np.asarray(x)
        special = {k: v["index"] for k, v in self.special_qp_params.items()}
        out = {"x": x[self.get_qp_mat_offset():] * self.coefficient_scale}
        out["R_inf"] = x[special["R_inf"]] * self.coefficient_scale \
            if "R_inf" in special else 0
        out.update(data_offset_parameters(x, self.special_qp_params, self.v_baseline_scale,
                                          self.scaled_response_offset,
                                          self.response_signal_scale))
        out["inductance"] = x[special["inductance"]] * (self.coefficient_scale
                                                        * self.inductance_scale) \
            if "inductance" in special else 0
        out["C_inv"] = x[special["C_inv"]] * (self.coefficient_scale * self.capacitance_scale) \
            if "C_inv" in special else 0
        if "background_scale" in special:
            out["background_scale"] = x[special["background_scale"]]
        if self.fit_dop:
            ds_, de_ = self.dop_indices
            out["x_dop"] = x[ds_:de_] * (self.dop_scale_vector * self.coefficient_scale)
        return out

    def get_drt_params(self, x=None, sign=1):
        """The DRT coefficients (:1677); of a series_neg fit the positive set
        (``sign`` 1), the negative one (-1) or their sum (0)."""
        if x is None:
            x = self.fit_parameters["x"]
        x = np.asarray(x)
        if self.series_neg:
            n = len(self.basis_tau)
            if sign == 1:
                return x[:n]
            if sign == -1:
                return -x[n:]
            return x[:n] - x[n:]
        return x

    def _drt_coef(self, params):
        """The coefficients of the distribution a prediction reads: a
        series_neg fit's two sets summed."""
        return self.get_drt_params(params["x"], sign=0) if self.series_neg else params["x"]

    def get_tau_eval(self, ppd, extend_decades=0):
        """Evaluation grid spanning basis_tau +- extend_decades (:1893)."""
        log_min = np.log10(np.min(self.basis_tau)) - extend_decades
        log_max = np.log10(np.max(self.basis_tau)) + extend_decades
        return np.logspace(log_min, log_max, int((log_max - log_min) * ppd) + 1)

    def predict_distribution(self, tau=None, ppd=20, order=0, x=None, sign=None,
                             normalize=False):
        """gamma(ln tau), or its order-th derivative in ln tau (order 0..3), on
        an evaluation grid (:1695); ``sign`` as ``get_drt_params``."""
        if tau is None:
            tau = self.get_tau_eval(ppd)
        em = basis_mod.func_eval_matrix_host(np.log(self.basis_tau),
                                             np.log(np.asarray(tau, dtype=float)),
                                             self.tau_basis_type, self.tau_epsilon, order,
                                             self.zga_params)
        if sign is None:
            sign = self.default_dist_sign()
        if x is None:
            x = self.get_drt_params(sign=sign) if self.series_neg else self.fit_parameters["x"]
        else:
            x = np.asarray(x)
            if len(x) > (2 if self.series_neg else 1) * len(self.basis_tau):
                # a raw solver vector: strip the specials and unscale
                x = self.extract_qphb_parameters(x)["x"]
            if len(x) > len(self.basis_tau):
                x = self.get_drt_params(x, sign)
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
        return self._impedance_matrix(f)

    def _get_response_pred_matrix(self, times, step_times, step_sizes, tau_rise=None):
        """The DRT block's step response at ``times``: rows of the fit
        matrix where the protocol is the fit's and the times are among the
        fit times, else a fresh matrix, cached by grid (:1968)."""
        sig = self._response_signature(step_times, step_sizes, tau_rise)
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
            basis_type=self.tau_basis_type, epsilon=self.tau_epsilon, tau_rise=tau_rise,
            op_mode=self.chrono_mode, integrate_method=self.integrate_method,
            zga_params=self.zga_params, interpolate_grids=self.interpolate_lookups["response"])
        self._pred_mat_cache["response"] = (sig, times.copy(), rm)
        return rm

    def _params(self, x):
        if x is None:
            return self.fit_parameters
        return x if isinstance(x, dict) else self.extract_qphb_parameters(x)

    def predict_z(self, frequencies=None, include_vz_offset=True, x=None, include_dop=True,
                  include_drt=True, include_inductance=True, include_ohmic=True,
                  include_cap=True):
        """Predicted impedance (:2004), the DOP's part included; a hybrid
        fit's times (1 - vz_offset times its coupling strength)."""
        if frequencies is None:
            frequencies = self.get_fit_frequencies()
        frequencies = np.asarray(frequencies, dtype=float)
        zm = self._get_impedance_pred_matrix(frequencies)
        params = self._params(x)
        z = np.zeros(len(frequencies), dtype=complex)
        if include_drt:
            z = z + zm @ self._drt_coef(params)
        if include_ohmic:
            z = z + params.get("R_inf", 0)
        if include_inductance:
            z = z + params.get("inductance", 0) * 2j * np.pi * frequencies
        if include_cap:
            z = z + params.get("C_inv", 0) / (2j * np.pi * frequencies)
        if self.fit_dop and include_dop and params.get("x_dop") is not None:
            zm_dop = phasance.construct_phasor_z_matrix(frequencies, self.basis_nu,
                                                        self.nu_basis_type, self.nu_epsilon)
            z = z + zm_dop @ params["x_dop"]
        if include_vz_offset and "vz_offset" in self.special_qp_params:
            _, vz_strength = self._get_vz_strength_vec(
                None, frequencies, vz_offset_eps=self.fit_parameters.get("vz_offset_eps"))
            z = z * (1 - params.get("vz_offset", 0) * vz_strength)
        return z

    def predict_response(self, times=None, step_times=None, step_sizes=None, x=None,
                         include_vz_offset=True, v_baseline=None):
        """Predicted chrono response (:2044): the DRT's, the ohmic
        resistance's, the capacitance's and the DOP's response to the steps,
        a hybrid fit's times (1 + vz_offset times its coupling strength),
        plus the voltage baseline."""
        if times is None:
            times = self.get_fit_times()
        times = np.asarray(times, dtype=float)
        step_times = self.step_times if step_times is None else step_times
        step_sizes = self.step_sizes if step_sizes is None else step_sizes
        rm = self._get_response_pred_matrix(times, step_times, step_sizes, self.tau_rise)
        params = self._params(x)
        response = rm @ self._drt_coef(params)
        inf_rv = mat1d.construct_ohmic_response_vector(
            times, self.step_model, step_times, step_sizes, self.tau_rise,
            pp.generate_model_signal(times, step_times, step_sizes, self.tau_rise,
                                     self.step_model), False, self.chrono_mode)
        response = response + params.get("R_inf", 0) * inf_rv
        if self.fit_capacitance:
            cap_rv = mat1d.construct_capacitance_response_vector(
                times, self.step_model, step_times, step_sizes, self.tau_rise, self.chrono_mode)
            response = response + params.get("C_inv", 0) * cap_rv
        if self.fit_dop and params.get("x_dop") is not None:
            rm_dop, _ = phasance.construct_phasor_v_matrix(
                times, self.basis_nu, self.nu_basis_type, self.nu_epsilon, self.step_model,
                step_times, step_sizes, self.chrono_mode)
            response = response + rm_dop @ params["x_dop"]
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

    def predict_r_p(self, absolute=False, x=None, raw=False, sign=None):
        """Polarization resistance: the DRT coefficients' sum times the basis
        area (:2101); ``sign`` as ``get_drt_params`` (default: a series_neg
        fit's two sets summed)."""
        area = basis_mod.get_basis_func_area(self.tau_basis_type, self.tau_epsilon,
                                             self.zga_params)
        if sign is None:
            sign = self.default_dist_sign()
        if raw:
            x = np.asarray(x)
            if len(x) > self.num_drt_params:
                x = x[self.get_qp_mat_offset():]
        else:
            x = self.get_drt_params(x, sign)
        return (np.sum(np.abs(x)) if absolute else np.sum(x)) * area

    def predict_r_inf(self):
        """R_inf, plus a delta-basis DOP's coefficient at nu = 0 (:2115)."""
        r_inf = self.fit_parameters.get("R_inf", 0)
        if self.fit_dop and self.nu_basis_type == "delta":
            zero_index = np.where(self.basis_nu == 0)[0]
            if len(zero_index) == 1:
                r_inf = r_inf + np.sum(self.fit_parameters["x_dop"][zero_index])
        return r_inf

    def predict_r_tot(self):
        return self.predict_r_inf() + self.predict_r_p()

    predict_drt = predict_distribution

    def integrate_drt(self, tau_min, tau_max, ppd=10, **predict_kw):
        """The distribution's integral over ln tau from ``tau_min`` to
        ``tau_max`` (:2126)."""
        num_decades = np.log10(tau_max) - np.log10(tau_min)
        tau = np.logspace(np.log10(tau_min), np.log10(tau_max), int(num_decades * ppd) + 1)
        gamma = self.predict_distribution(tau, **predict_kw)
        return np.trapezoid(gamma, x=np.log(tau))

    integrate_distribution = integrate_drt

    def get_drt_norm(self, normalize, normalize_by=None, x=None, absolute=False):
        """Normalization constant of distribution queries (:2155)."""
        if normalize_by is not None:
            return normalize_by
        if normalize:
            return self.predict_r_p(x=x, absolute=absolute)
        return 1.0

    def default_dist_sign(self):
        return 0 if self.series_neg else 1

    def get_data_tau_limits(self):
        """(tau_min, tau_max) covered by the measured data (:2451)."""
        return pp.get_tau_lim(self.get_fit_frequencies(True), self.get_fit_times(True),
                              self.nonconsec_step_times)

    # ------------------------------------------------------------------
    # The distribution of phasances (:1832-1860, :2135-2147, :2386-2445)
    # ------------------------------------------------------------------
    def _check_dop(self):
        if not self.fit_dop:
            raise ValueError("DOP was not fitted")

    def predict_dop(self, nu=None, x=None, order=0, normalize=False, normalize_tau=None,
                    delta_density=False):
        """The DOP over ``nu`` (default 201 points on [-1, 1]) (:1832);
        ``normalize`` divides by the phasor scale over ``normalize_tau``
        (default the basis)."""
        self._check_dop()
        if nu is None:
            nu = np.linspace(-1, 1, 201)
        if x is None:
            x = self.fit_parameters["x_dop"]
        em = basis_mod.func_eval_matrix_host(np.asarray(self.basis_nu), np.asarray(nu),
                                             self.nu_basis_type, self.nu_epsilon, order)
        out = em @ np.asarray(x)
        if normalize:
            tau_ref = normalize_tau if normalize_tau is not None else self.basis_tau
            out = out / phasance.phasor_scale_vector(nu, tau_ref)
        return out

    @property
    def tau_basis_area(self):
        return basis_mod.get_basis_func_area(self.tau_basis_type, self.tau_epsilon,
                                             self.zga_params)

    @property
    def nu_basis_area(self):
        return basis_mod.get_basis_func_area(self.nu_basis_type, self.nu_epsilon)

    def get_dop_norm(self, nu, normalize=False, normalize_tau=None,
                     normalize_quantiles=(0.25, 0.75)):
        """The normalization vector of DOP queries (:2135): the phasor scale
        over the data's tau range divided by the nu basis's area."""
        if not normalize:
            return 1.0
        if normalize_tau is None:
            normalize_tau = pp.get_tau_lim(self.get_fit_frequencies(True),
                                           self.get_fit_times(True), self.nonconsec_step_times)
        sv = phasance.phasor_scale_vector(np.asarray(nu), np.asarray(normalize_tau),
                                          normalize_quantiles)
        return sv / basis_mod.get_basis_func_area(self.nu_basis_type, self.nu_epsilon)

    def estimate_dop_cov(self, nu=None, p_matrix=None, normalize=False, normalize_tau=None,
                         var_floor=0.0, order=0, delta_density=False):
        """Covariance of the DOP at ``nu`` (default the basis) from the
        Laplace posterior (:2386)."""
        self._check_dop()
        if nu is None:
            nu = self.basis_nu
        em = basis_mod.func_eval_matrix_host(np.asarray(self.basis_nu), np.asarray(nu),
                                             self.nu_basis_type, self.nu_epsilon, order)
        ds_, de_ = self.dop_indices
        x_cov = self.estimate_param_cov(p_matrix=p_matrix)[ds_:de_, ds_:de_]
        if delta_density and self.nu_basis_type == "delta":
            x_cov = x_cov / self.get_nu_basis_spacing()
        dist_cov = em @ x_cov @ em.T
        if normalize:
            tau_ref = normalize_tau if normalize_tau is not None else self.basis_tau
            sv = phasance.phasor_scale_vector(np.asarray(nu), tau_ref)
            dist_cov = dist_cov / (sv[:, None] * sv[None, :])
        if var_floor > 0:
            dist_cov[np.diag_indices_from(dist_cov)] = np.maximum(np.diag(dist_cov), var_floor)
        return dist_cov

    def predict_dop_ci(self, nu=None, x=None, normalize=False, normalize_tau=None,
                       quantiles=(0.025, 0.975), order=0, delta_density=False):
        """Credible interval of the DOP (:2414)."""
        if nu is None:
            nu = self.basis_nu
        dist_cov = self.estimate_dop_cov(nu=nu, order=order, normalize=normalize,
                                         normalize_tau=normalize_tau,
                                         delta_density=delta_density)
        sigma = np.sqrt(np.maximum(np.diag(dist_cov), 0))
        mu = self.predict_dop(nu=nu, x=x, order=order, normalize=normalize,
                              normalize_tau=normalize_tau, delta_density=delta_density)
        out = [mu + ndtri(q) * sigma for q in quantiles]
        return out[0], out[1]

    def get_nu_basis_spacing(self):
        """Each nu basis point's smaller spacing to a neighbour (:2432)."""
        basis_nu = self.fixed_basis_nu if self.fixed_basis_nu is not None else self.basis_nu
        dnu = np.diff(np.sort(np.asarray(basis_nu)))
        dnu = np.minimum(dnu[1:], dnu[:-1])
        med = np.median(dnu) if len(dnu) else 1.0
        return np.concatenate([[med], dnu, [med]])

    def get_dop_params(self, x=None):
        if x is None:
            x = self.fit_parameters["x_dop"]
        return np.asarray(x)

    # ------------------------------------------------------------------
    # The Laplace posterior (:2166-2385)
    # ------------------------------------------------------------------
    def _p_matrix(self, p_matrix=None):
        if p_matrix is None:
            if self.qphb_params is not None:
                p_matrix = self.qphb_params["p_matrix"]
            else:
                # rebuilt batched and ragged fits carry (P, q) in fit_parameters
                p_matrix = self.fit_parameters.get("p_matrix")
            if p_matrix is None:
                raise ValueError("No P matrix available; fit first or pass p_matrix")
        return np.asarray(p_matrix)

    def estimate_param_cov(self, p_matrix=None):
        """The posterior covariance P^-1 in physical units (:2168): the
        inverse in float64 on the fit's device (``mat1d.invert_psd``), host
        numpy out."""
        p_matrix = self._p_matrix(p_matrix)
        p_inv = mat1d.invert_psd(torch.as_tensor(p_matrix, dtype=torch.float64,
                                                 device=self.device)).cpu().numpy()
        return self.scale_param_cov(p_inv)

    def scale_param_cov(self, p_inv):
        """P^-1 (solver units, host numpy) in physical units: each column's
        factor from solver to physical units (:2181-2194)."""
        scale_vec = np.ones(p_inv.shape[0]) * self.coefficient_scale
        for name in self.special_qp_params:
            start, end = self.get_special_indices(name)
            if name == "v_baseline":
                scale_vec[start:end] = self.response_signal_scale / self.v_baseline_scale
            elif name == "inductance":
                scale_vec[start:end] = self.coefficient_scale * self.inductance_scale
            elif name == "C_inv":
                scale_vec[start:end] = self.coefficient_scale * self.capacitance_scale
            elif name == "vz_offset":
                scale_vec[start:end] = 1.0
            elif name == "x_dop":
                scale_vec[start:end] = self.coefficient_scale * self.dop_scale_vector
        return p_inv * scale_vec[:, None] * scale_vec[None, :]

    def estimate_distribution_cov(self, tau=None, ppd=20, order=0, extend_var=True,
                                  p_matrix=None, sign=None, normalize=False, var_floor=0.0):
        """Covariance of gamma(ln tau), or of its order-th derivative, B
        Sigma_x B^T (:2319); ``extend_var`` extrapolates the variance beyond
        the basis (:2344-2362); of a series_neg fit the covariance of the
        set ``sign`` selects (default: the sum)."""
        if tau is None:
            tau = self.get_tau_eval(ppd)
        return self.distribution_cov(self.estimate_param_cov(p_matrix=p_matrix), tau, order,
                                     extend_var, normalize, var_floor, sign=sign)

    def distribution_cov(self, cov, tau, order=0, extend_var=True, normalize=False,
                         var_floor=0.0, sign=None):
        """``estimate_distribution_cov`` from the parameter covariance ``cov``
        (host numpy, physical units)."""
        ns = self.get_qp_mat_offset()
        cov_drt = cov[ns:, ns:]
        tau = np.asarray(tau)
        em = basis_mod.func_eval_matrix_host(np.log(self.basis_tau), np.log(tau),
                                             self.tau_basis_type, self.tau_epsilon, order,
                                             self.zga_params)
        if self.series_neg:
            sign = 0 if sign is None else sign
            zero = np.zeros_like(em)
            em = np.hstack({0: [em, -em], 1: [em, zero]}.get(sign, [zero, -em]))
        dist_cov = em @ cov_drt @ em.T
        if normalize:
            dist_cov = dist_cov / self.predict_r_p(absolute=True) ** 2
        if var_floor:
            dist_cov[np.diag_indices_from(dist_cov)] = np.maximum(np.diag(dist_cov), var_floor)
        if extend_var:
            var = np.diag(dist_cov).copy()
            left = tau < self.basis_tau[0]
            right = tau > self.basis_tau[-1]
            if left.any():
                ref_var = var[~left][0] if (~left).any() else 0
                var[left] += ref_var * np.log(self.basis_tau[0] / tau[left]) ** 2
                dist_cov[left, left] = var[left]
            if right.any():
                ref_var = var[~right][-1] if (~right).any() else 0
                var[right] += ref_var * np.log(tau[right] / self.basis_tau[-1]) ** 2
                dist_cov[right, right] = var[right]
        return dist_cov

    def predict_drt_ci(self, tau=None, ppd=20, order=0, quantiles=(0.025, 0.975), x=None,
                       sign=None, normalize=False):
        """Credible interval of the distribution from the Laplace posterior
        (:2366): the mean plus ndtri(q) sigma for each of ``quantiles``."""
        if tau is None:
            tau = self.get_tau_eval(ppd)
        dist_cov = self.estimate_distribution_cov(tau=tau, order=order, sign=sign,
                                                  normalize=normalize)
        sigma = np.sqrt(np.maximum(np.diag(dist_cov), 0))
        mu = self.predict_distribution(tau=tau, order=order, x=x, sign=sign,
                                       normalize=normalize)
        out = [mu + ndtri(q) * sigma for q in quantiles]
        return out[0], out[1]

    predict_distribution_ci = predict_drt_ci

    # ------------------------------------------------------------------
    # Diagnostics (:2470-2525)
    # ------------------------------------------------------------------
    def predict_sigma(self, measurement):
        """The fit's data-space noise level, "chrono" or "eis" (:2470)."""
        key = {"chrono": "v_sigma_tot", "eis": "z_sigma_tot"}.get(measurement)
        if key is None:
            raise ValueError(f"Invalid measurement {measurement}; options: 'chrono', 'eis'")
        return self.fit_parameters.get(key, None)

    def split_r_p(self, tau_splits, resolve_peaks=False, **predict_kw):
        """Rp split into its parts between ``tau_splits`` (:2479)."""
        tau_splits = sorted(tau_splits)
        if "tau" in predict_kw:
            tau = np.asarray(predict_kw.pop("tau"))
        else:
            tau = self.get_tau_eval(predict_kw.pop("ppd", 20))
        gamma = self.predict_distribution(tau, **predict_kw)
        split_index = [nearest_index(tau, ts) for ts in tau_splits]
        start_index = np.array([0] + split_index)
        end_index = np.array(split_index + [len(tau)]) + 1
        if resolve_peaks:
            fxx = self.predict_distribution(tau, order=2, **predict_kw)
            peak_index = [int(np.argmin(fxx[i:j])) + i for i, j in zip(start_index, end_index)]
            peak_coef = self.estimate_peak_coef(tau, peak_indices=peak_index)
            return np.array([self.predict_r_p(x=pc) for pc in peak_coef])
        return np.array([np.trapezoid(gamma[i:j], x=np.log(tau[i:j]))
                         for i, j in zip(start_index, end_index)])

    def evaluate_chi_sq(self, frequencies=None, z=None, x=None, weights=None, **predict_kw):
        """Chi-squared of the impedance fit (:2501); ``weights="modulus"``
        weights by 1/|z|."""
        if frequencies is None:
            frequencies = self.get_fit_frequencies()
        if z is None:
            z = self.z_fit
        if weights is not None:
            if isinstance(weights, str) and weights == "modulus":
                weights = 1 / np.abs(z)
            elif np.shape(weights) != np.shape(z):
                raise ValueError("Weights must have same shape as z")
        z_hat = self.predict_z(frequencies, x=x, **predict_kw)
        return evaluation.chi_sq(z, z_hat, weights=weights)

    def fisher_matrix(self, weighted=True):
        """Gauss-Newton information matrix of the data fit, (W rm)^T (W rm)
        (:2517)."""
        rm = np.asarray(self.qphb_params["rm"])
        if weighted:
            rm = rm * np.asarray(self.qphb_params["weights"])[:, None]
        return rm.T @ rm

    # ------------------------------------------------------------------
    # Likelihoods (:2886-2935), in float64 on the fit's device
    # ------------------------------------------------------------------
    def _lane(self, a):
        return torch.as_tensor(np.array(a, dtype=float), dtype=torch.float64,
                               device=self.device)[None]

    def evaluate_rss(self, weights=None):
        if weights is None:
            weights = self.qphb_params["weights"]
        qp = self.qphb_params
        return float(qphb_mod.evaluate_rss(self._lane(self._raw_x()), self._lane(qp["rm"])[0],
                                           self._lane(qp["rv"]), self._lane(weights))[0])

    def evaluate_llh(self, weights=None, x=None, marginalize_weights=True, alpha_0=2, beta_0=1):
        if weights is None:
            weights = self.qphb_params["weights"]
        qp = self.qphb_params
        x = self._raw_x() if x is None else np.asarray(x)
        return float(qphb_mod.evaluate_llh(
            self._lane(x), self._lane(qp["rm"])[0], self._lane(qp["rv"]), self._lane(weights),
            marginalize_weights=marginalize_weights, alpha_0=alpha_0, beta_0=beta_0)[0])

    def evaluate_bic(self, **llh_kw):
        llh = self.evaluate_llh(**llh_kw)
        return bic(llh, len(self._raw_x()), self.num_data)

    def evaluate_lml(self, **kw):
        qp = self.qphb_params
        hyp = qphb_mod.hypers_to_tensors(qp["hypers"], self.device, torch.float64)
        m_stack = torch.stack([self._lane(qp["penalty_matrices"][f"m{k}"])[0] for k in range(3)])
        return float(qphb_mod.evaluate_lml(
            self._lane(self._raw_x()), self._lane(qp["rm"])[0], self._lane(qp["rv"]), m_stack,
            hyp, self._lane(qp["l1_lambda_vector"])[0], self._lane(qp["rho_vector"]),
            self._lane(np.stack(qp["s_vectors"])), self._lane(qp["weights"]), qp["cfg"],
            dop_rho_vector=self._lane(self._dop_rho(qp)), **kw)[0])

    @staticmethod
    def _dop_rho(qp):
        """The fit's DOP derivative strengths, ones without a DOP."""
        dr = qp.get("dop_rho_vector")
        return np.ones(qp["cfg"].k_range) if dr is None else dr

    def _raw_x(self):
        """The scaled (solver) parameter vector rebuilt from fit_parameters
        (:2922)."""
        fp = self.fit_parameters
        x = np.zeros(self.qphb_params["rm"].shape[1])
        x[self.get_qp_mat_offset():] = fp["x"] / self.coefficient_scale
        for name in self.special_qp_params:
            start, end = self.get_special_indices(name)
            if name == "R_inf":
                x[start] = fp["R_inf"] / self.coefficient_scale
            elif name == "inductance":
                x[start] = fp["inductance"] / (self.coefficient_scale * self.inductance_scale)
            elif name == "C_inv":
                x[start] = fp["C_inv"] / (self.coefficient_scale * self.capacitance_scale)
            elif name == "x_dop":
                x[start:end] = fp["x_dop"] / (self.dop_scale_vector * self.coefficient_scale)
            elif name in ("vz_offset", "background_scale"):
                x[start] = fp[name]
            elif name == "v_baseline":
                vb = np.atleast_1d(fp["v_baseline"]) / self.response_signal_scale
                vb = vb * self.v_baseline_scale
                vb[0] += self.scaled_response_offset * self.v_baseline_scale[0] \
                    if np.ndim(self.v_baseline_scale) else self.scaled_response_offset
                x[start:end] = vb
        return x

    # ------------------------------------------------------------------
    # Peaks (:1728-1835, :2525-2560)
    # ------------------------------------------------------------------
    def find_peaks(self, tau=None, x=None, normalize=True, ppd=10, prominence=None,
                   height=None, sign=1, return_info=False, method="thresh", prob_thresh=0.25,
                   fxx_var_floor=1e-5, num_peaks=None, **kw):
        """Peaks of the distribution at the minima of its curvature, kept
        with ``method="prob"`` where their posterior probability reaches
        ``prob_thresh`` (:1728)."""
        if method not in ("thresh", "prob"):
            raise ValueError(f"Invalid method {method}; options: thresh, prob")
        if tau is None:
            tau = self.get_tau_eval(ppd)
        tau = np.asarray(tau)
        fxx = self.predict_distribution(tau=tau, x=x, order=2, sign=sign, normalize=normalize)
        if prominence is None:
            prominence = 0.05 * np.std(fxx[~np.isinf(fxx)]) + 5e-3 \
                if method == "thresh" else 5e-3
        if height is None:
            height = 0 if method == "thresh" else 1e-3

        if (self.fit_kwargs or {}).get("nonneg", True) and sign != 0:
            peak_indices, peak_info = sp_signal.find_peaks(-sign * fxx, height=height,
                                                           prominence=prominence, **kw)
        else:
            f = self.predict_distribution(tau=tau, x=x, order=0, sign=sign, normalize=normalize)
            idx_list, info_list = [], []
            for peak_sign in (-1, 1):
                p_idx, p_info = sp_signal.find_peaks(-peak_sign * fxx, height=height,
                                                     prominence=prominence, **kw)
                pos = peak_sign * f[p_idx] > 0
                idx_list.append(p_idx[pos])
                info_list.append({k: v[pos] for k, v in p_info.items()})
            peak_indices = np.concatenate(idx_list)
            peak_info = {k: np.concatenate([pi[k] for pi in info_list])
                         for k in info_list[0].keys()}
            order_idx = np.argsort(peak_indices)
            peak_indices = peak_indices[order_idx]
            peak_info = {k: v[order_idx] for k, v in peak_info.items()}

        if method == "prob" and len(peak_indices) > 0:
            min_prom = np.minimum(peak_info["prominences"], peak_info["peak_heights"])
            fxx_cov = self.estimate_distribution_cov(tau=tau, order=2)
            fxx_sigma = np.sqrt(np.maximum(np.diag(fxx_cov), fxx_var_floor))
            if normalize:
                fxx_sigma = fxx_sigma / self.predict_r_p(absolute=True)
            # P(|peak| > 0) from the normal posterior of the curvature
            peak_prob = 2 * ndtr(min_prom / fxx_sigma[peak_indices]) - 1
            if num_peaks is not None:
                prob_sort = np.sort(peak_prob)[::-1]
                prob_thresh = prob_sort[min(num_peaks - 1, len(peak_prob) - 1)]
            peak_info["probs"] = peak_prob
            peak_indices = peak_indices[peak_prob >= prob_thresh]

        if return_info:
            return tau[peak_indices], tau, peak_indices, peak_info
        return tau[peak_indices]

    def estimate_peak_coef(self, tau=None, peak_indices=None, x=None, sign=1,
                           epsilon_factor=1.25, max_epsilon=1.25, min_epsilon=None,
                           epsilon_uniform=None, peak_tau=None, trough_tau=None,
                           **find_peaks_kw):
        """The coefficient vector split into one part per peak (:1787)."""
        if peak_indices is not None and tau is None:
            raise ValueError("If peak_indices are provided, the tau grid must also be provided")
        x = self.get_drt_params(x, sign)
        if peak_indices is None and peak_tau is None:
            _, tau, peak_indices, _ = self.find_peaks(x=x, sign=sign, return_info=True,
                                                      **find_peaks_kw)
        if tau is None:
            tau = self.get_tau_eval(10)
        f = self.predict_distribution(tau, x=x, sign=sign)
        fxx = self.predict_distribution(tau, x=x, sign=sign, order=2)
        peak_weights = peaks_mod.estimate_peak_weight_distributions(
            tau, f, fxx, peak_indices, self.basis_tau, epsilon_factor, max_epsilon,
            min_epsilon, epsilon_uniform, peak_tau=peak_tau, trough_tau=trough_tau)
        return x * peak_weights

    def estimate_peak_distributions(self, tau=None, ppd=10, tau_find_peaks=None,
                                    peak_indices=None, x=None, sign=1, find_peaks_kw=None,
                                    **peak_coef_kw):
        """Each peak's gamma(ln tau) on an evaluation grid (:1809)."""
        if tau is None:
            tau = self.get_tau_eval(ppd)
        if find_peaks_kw:
            peak_coef_kw = {**find_peaks_kw, **peak_coef_kw}
        x_peaks = self.estimate_peak_coef(tau=tau_find_peaks, peak_indices=peak_indices, x=x,
                                          sign=sign, **peak_coef_kw)
        return np.stack([self.predict_distribution(tau, x=xp) for xp in x_peaks])

    estimate_peak_drts = estimate_peak_distributions

    def quantify_peaks(self, tau=None, ppd=10, **kw):
        """Each peak's polarization resistance (:1826)."""
        x_peaks = self.estimate_peak_coef(tau=tau, **kw)
        return np.array([self.predict_r_p(x=xp) for xp in x_peaks])

    def predict_peak_trough_probs(self, tau=None, x=None, bayes_cov=True, p_matrix=None):
        """Pointwise P(peak) and P(trough) from the distribution, its first
        two derivatives and their posterior variances (:2525)."""
        if tau is None:
            tau = self.get_tau_eval(10)
        mus, bvar = [], []
        cov = self.estimate_param_cov(p_matrix=p_matrix) if bayes_cov else None
        for order in (0, 1, 2):
            mus.append(self.predict_distribution(tau, x=x, order=order))
            if bayes_cov:
                sigma = np.diag(self.distribution_cov(cov, tau, order=order,
                                                      extend_var=True)) ** 0.5
                # the floor on sigma (reference drt1d.py:3676-3680)
                iqr = np.percentile(sigma, 75) - np.percentile(sigma, 25)
                sigma = np.maximum(sigma, np.median(sigma) - 1.5 * iqr)
                bvar.append(sigma ** 2)
        f_var, fx_var, fxx_var = bvar if bayes_cov else (None, None, None)
        pp_ = surface.peak_prob(*mus, f_var=f_var, fx_var=fx_var, fxx_var=fxx_var)
        tp_ = surface.trough_prob(*mus, f_var=f_var, fx_var=fx_var, fxx_var=fxx_var)
        return pp_, tp_

    def predict_peak_prob(self, tau=None, x=None, bayes_cov=True, p_matrix=None):
        """Probability of a peak over tau, P(peak) (1 - P(trough)) (:2549)."""
        pp_, tp_ = self.predict_peak_trough_probs(tau, x, bayes_cov=bayes_cov,
                                                  p_matrix=p_matrix)
        return pp_ * (1 - tp_)

    def find_peaks_byprob(self, tau=None, x=None, prob=None, height=None, prominence=None,
                          bayes_cov=True, p_matrix=None, return_info=False):
        """Peaks of the peak-probability function (:2555)."""
        if tau is None:
            tau = self.get_tau_eval(10)
        tau = np.asarray(tau)
        if prob is None:
            prob = self.predict_peak_prob(tau, x, bayes_cov=bayes_cov, p_matrix=p_matrix)
        peak_indices, peak_info = sp_signal.find_peaks(prob, height=height,
                                                       prominence=prominence)
        if return_info:
            return tau[peak_indices], tau, peak_indices, peak_info
        return tau[peak_indices]

    # ------------------------------------------------------------------
    # MAP samples (:2197-2318)
    # ------------------------------------------------------------------
    def generate_map_samples(self, shift_scale=1.5, deltas=(-3, -2, -1, 1, 2, 3),
                             refresh=False):
        """The posterior explored around the MAP by conditional
        re-optimization (:2197): for each DRT coefficient i and shift delta,
        x_i is pinned at x_hat_i + delta sigma_i shift_scale (sigma from the
        Laplace covariance P^-1, held at its lower bound) and the other
        coordinates are re-optimized under the fit's final hyperparameters;
        each sample's joint log posterior is recorded. The MAP is first
        refined against the final (P, q) from the stored iterate.

        All pinned QPs (row and column i of P zeroed, a unit diagonal there,
        q_i = -v) go to ``ops.qp.solve_qp_box`` as one batch of
        len(deltas) x n_drt QPs, in the fit's dtype on its device, so on
        the card the lane kernels carry them (#1-#3 where n takes their tile
        rule, else the library route). Cached by keyword in
        ``self.map_samples``: raw-space ``x`` (n_samples, n), ``lp``,
        ``lp_hat``, ``x_hat``, ``index`` and ``delta``."""
        kwargs = {"shift_scale": shift_scale, "deltas": tuple(deltas)}
        if not refresh and self.map_samples is not None and self.map_sample_kw == kwargs:
            return self.map_samples
        if self.qphb_params is None or "x_raw" not in self.qphb_params:
            raise ValueError("Fit the model (fit_eis/fit_chrono/fit_hybrid) before sampling")
        qp = self.qphb_params
        t = self._t
        P = t(qp["p_matrix"])
        q = t(qp["q_vector"])
        lb = t(qp["lb"])
        n = P.shape[0]
        ns = self.get_qp_mat_offset()

        p_inv = mat1d.invert_psd(torch.as_tensor(np.asarray(qp["p_matrix"], dtype=float),
                                                 dtype=torch.float64, device=self.device))
        sigma_x = torch.sqrt(torch.clamp(torch.diagonal(p_inv), min=0)).to(self.dtype)
        x_hat = qp_mod.solve_qp_box(P[None], q[None], lb, x_init=t(qp["x_raw"])[None]).x[0]

        idx = torch.as_tensor(np.repeat(np.arange(ns, n), len(deltas)), device=self.device)
        dlt = t(np.tile(np.asarray(deltas, dtype=float), n - ns))
        v = torch.maximum(x_hat[idx] + dlt * sigma_x[idx] * shift_scale, lb[idx])
        keep = 1.0 - torch.nn.functional.one_hot(idx, n).to(P.dtype)  # 0 at the pinned i
        p_pin = P * keep[:, :, None] * keep[:, None, :] + torch.diag_embed(1.0 - keep)
        q_pin = keep * (q + P[:, idx].mT * v[:, None]) - (1.0 - keep) * v[:, None]
        x_samples = qp_mod.solve_qp_box(p_pin, q_pin, lb).x

        lane = lambda a: t(np.asarray(a, dtype=float))
        k_range = qp["cfg"].k_range
        m_stack = torch.stack([lane(qp["penalty_matrices"][f"m{k}"]) for k in range(k_range)])
        lp_args = (lane(qp["rm"]), lane(qp["rv"]), m_stack, self._hyp(qp["hypers"]),
                   lane(qp["l1_lambda_vector"]), lane(qp["rho_vector"]),
                   torch.stack([lane(s_) for s_ in qp["s_vectors"]]), lane(qp["weights"]),
                   lane(qp["xmx_norms"]), qp["cfg"])
        dop_rho = lane(self._dop_rho(qp))
        lp = qphb_mod.evaluate_posterior_lp(x_samples, *lp_args, dop_rho_vector=dop_rho)
        lp_hat = qphb_mod.evaluate_posterior_lp(x_hat[None], *lp_args,
                                                dop_rho_vector=dop_rho)[0]
        self.map_samples = {"x": self._to_numpy(x_samples), "lp": self._to_numpy(lp),
                            "lp_hat": float(lp_hat), "x_hat": self._to_numpy(x_hat),
                            "index": np.repeat(np.arange(ns, n), len(deltas)),
                            "delta": np.tile(np.asarray(deltas, dtype=float), n - ns)}
        self.map_sample_kw = kwargs
        return self.map_samples

    def _weighted_samples(self, **sample_kw):
        samples = self.generate_map_samples(**sample_kw)
        x_all = np.vstack([samples["x_hat"][None, :], samples["x"]])
        lp_all = np.concatenate([[samples["lp_hat"]], samples["lp"]])
        return x_all, np.exp(lp_all - np.max(lp_all))

    def get_parameter_quantile(self, quantile, **sample_kw):
        """Posterior parameter quantiles from the lp-weighted MAP samples,
        the MAP among them (:2293): (n_quantiles, n) raw-space values."""
        x_all, w = self._weighted_samples(**sample_kw)
        return weighted_quantile_2d(x_all, np.atleast_1d(quantile), sample_weight=w)

    def estimate_posterior_mean(self, **sample_kw):
        """The posterior mean of the raw-space vector from the lp-weighted
        MAP samples, the MAP among them (:2306)."""
        x_all, w = self._weighted_samples(**sample_kw)
        return np.average(x_all, axis=0, weights=w)

    # ------------------------------------------------------------------
    # The chrono GP background (:2953-2985)
    # ------------------------------------------------------------------
    def estimate_chrono_background(self, times, i_signal, v_signal, bkg_iter=1,
                                   kernel_type="gaussian", copy_self=False, gp_kw=None,
                                   **fit_kw):
        """Fit the DRT and a GP to the residual drift in turn, ``bkg_iter``
        times (:2953); returns (drt_bkg if copy_self, [gp], y_bkg)."""
        drt_bkg = deepcopy(self) if copy_self else self
        drt_bkg.warn = False
        times = np.asarray(times)
        y_bkg = np.zeros(len(times))
        gp = None
        resp = np.asarray(v_signal, dtype=float)
        other = np.asarray(i_signal)
        for _ in range(max(bkg_iter, 1)):
            drt_bkg.fit_chrono(times, other, resp - y_bkg, **fit_kw)
            resid = resp - y_bkg - drt_bkg.predict_response(times)
            gp = bkg_mod.GPBackground(kernel_type=kernel_type, **(gp_kw or {}))
            gp.fit(times, resid)
            y_bkg = y_bkg + gp.predict(times)
        if copy_self:
            return drt_bkg, [gp], y_bkg
        return [gp], y_bkg

    def predict_chrono_background(self, times):
        if self.background_gp is None:
            return np.zeros(len(np.atleast_1d(times)))
        return self.background_gp.predict(times)

    # ------------------------------------------------------------------
    # Attribute persistence (:3886-3925)
    # ------------------------------------------------------------------
    @property
    def attribute_categories(self):
        return {
            "config": [
                "fixed_basis_tau", "tau_supergrid", "basis_tau", "tau_basis_type",
                "tau_epsilon", "extend_basis_decades", "step_model", "chrono_mode",
                "fixed_basis_nu", "basis_nu", "nu_basis_type", "nu_epsilon", "fit_dop",
                "normalize_dop", "fit_inductance", "fit_ohmic", "fit_capacitance",
                "series_neg", "integrate_method", "v_baseline_deg", "v_baseline_sqrt",
            ],
            "fit_core": [
                "fit_parameters", "fit_type", "fit_kwargs", "special_qp_params",
                "coefficient_scale", "impedance_scale", "input_signal_scale",
                "response_signal_scale", "inductance_scale", "capacitance_scale",
                "dop_scale_vector", "v_baseline_scale", "scaled_response_offset",
                "qphb_params", "step_times", "step_sizes", "tau_rise",
                "nonconsec_step_times", "t_fit", "f_fit", "z_fit", "z_fit_scaled",
                "raw_input_signal", "raw_response_signal",
            ],
            # pfrt_result is None for every fit but a PFRT sweep's (ROADMAP
            # Queue 1 item 9), as in the JAX package
            "detail": ["qphb_history", "pfrt_result", "fit_matrices"],
        }

    def get_attributes(self, which=None):
        """The attributes of the categories ``which`` (default "config" and
        "fit_core") as a dict of deep copies."""
        cats = self.attribute_categories
        if which is None:
            which = ["config", "fit_core"]
        if isinstance(which, str):
            which = [which]
        return {name: deepcopy(getattr(self, name, None)) for cat in which for name in cats[cat]}

    def set_attributes(self, att_dict):
        for k, v in att_dict.items():
            setattr(self, k, v)
        return self

    def save_attributes(self, which, dest):
        """Pickle the attributes of the categories ``which`` to ``dest``
        (:3927); the JAX ``DRT.load_attributes`` reads the file."""
        import pickle
        with open(dest, "wb") as f:
            pickle.dump(self.get_attributes(which), f)

    def load_attributes(self, source):
        """Set the attributes of a dict, or of a ``save_attributes`` pickle,
        this class's or the JAX class's, read without JAX
        (``mapping/drtmd.py::load_pickle``: its QPHBConfig as the port's,
        its arrays, a "detail" history's, as numpy arrays) (:3932)."""
        if isinstance(source, dict):
            return self.set_attributes(source)
        from ..mapping.drtmd import load_pickle
        return self.set_attributes(load_pickle(source))


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
    ``inductance_scale``, ``input_signal_scale``, ``v_baseline_scale``, ``rp_scale``."""
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
        "v_baseline_scale": sys_["v_baseline_scale"], "rp_scale": hyper_kw.get("rp_scale", 14.0),
    }
