"""EIS problem assembly for the batched fit.

Counterpart of the matrix-building half of ``hybdrt_tpu/models/drt.py``: the
JAX ``BatchedEISFitter`` reads its problem matrices from a template
``DRT.fit_eis`` (``hybdrt_tpu/parallel/batch.py:204-246``). The port builds
the same arrays directly, following ``_prep_for_fit`` (drt.py:464),
``_prep_impedance_fit_matrix`` (:613), ``_prep_penalty_matrices`` (:657),
``_format_qp_matrices`` (:695), ``_make_lower_bound`` (:800) and the EIS
branch of ``_qphb_fit_core`` (:1040-1300), for the gaussian basis with
``integrate_method="interp"``. The ``DRT`` class itself is not ported yet.
"""
import numpy as np

from .. import preprocessing as pp
from ..ops import lookup, mat1d
from ..solver import hypers as hyp_mod
from ..solver.qphb import QPHBConfig


def _make_lower_bound(n, nonneg, special_qp_params):
    if nonneg:
        lb = np.zeros(n)
        for sp in special_qp_params.values():
            if not sp["nonneg"]:
                lb[sp["index"]:sp["index"] + sp["size"]] = -1000.0
    else:
        lb = np.full(n, -1e5)
        for sp in special_qp_params.values():
            if sp["nonneg"]:
                lb[sp["index"]:sp["index"] + sp["size"]] = 0.0
    return lb


def build_eis_problem(frequencies, basis_tau=None, tau_supergrid=None, fit_ohmic=True,
                      fit_inductance=True, nonneg=True, iw_l1_lambda_0=1e-4,
                      iw_l2_lambda_0=1e-4, fit_capacitance=False, fit_dop=False,
                      tau_basis_type="gaussian", integrate_method="interp", **hyper_kw):
    """Assemble the shared EIS QP problem for one frequency grid.

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
        raise NotImplementedError("fit_dop: DOP assembly is not ported yet (ROADMAP Queue 1 item 4)")
    if fit_capacitance:
        raise NotImplementedError("fit_capacitance: capacitance assembly is not ported yet "
                                  "(ROADMAP Queue 1 item 4)")
    if tau_basis_type != "gaussian":
        raise NotImplementedError(f"tau_basis_type={tau_basis_type!r}: gaussian only")
    if integrate_method != "interp":
        raise NotImplementedError(f"integrate_method={integrate_method!r}: 'interp' only")

    hypers = hyp_mod.get_default_hypers(eff_hp=True, fit_dop=False)
    for key in hyper_kw:
        if key not in hypers:
            raise ValueError(f"Invalid keyword argument {key}")
    hypers.update(hyper_kw)
    if hypers.get("outlier_p") is not None:
        raise NotImplementedError("outlier_p: the outlier model is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")

    frequencies = np.asarray(frequencies, dtype=float)
    if basis_tau is not None:
        basis_tau = np.asarray(basis_tau, dtype=float)
        tau_epsilon = 1 / np.mean(np.diff(np.log(basis_tau)))
    elif tau_supergrid is not None:
        tau_supergrid = np.asarray(tau_supergrid, dtype=float)
        tau_epsilon = 1 / np.mean(np.diff(np.log(tau_supergrid)))
        basis_tau = pp.get_basis_tau(frequencies, extend_decades=1, tau_grid=tau_supergrid)
    else:
        tau_epsilon = pp.get_epsilon_from_ppd(10)
        basis_tau = pp.get_basis_tau(frequencies, extend_decades=1)

    special_qp_params = {}
    for name, on in (("R_inf", fit_ohmic), ("inductance", fit_inductance)):
        if on:
            special_qp_params[name] = {"index": len(special_qp_params), "nonneg": True,
                                       "size": 1}
    ns = len(special_qp_params)
    n = len(basis_tau) + ns

    # Impedance design matrix with special columns, stacked [Re; Im]
    zre_lu, zim_lu = lookup.generate_impedance_lookup("gaussian", float(tau_epsilon))
    zm_drt = mat1d.construct_impedance_matrix(frequencies, "real", basis_tau,
                                              epsilon=tau_epsilon,
                                              interpolate_grids=zre_lu) \
        + 1j * mat1d.construct_impedance_matrix(frequencies, "imag", basis_tau,
                                                epsilon=tau_epsilon,
                                                interpolate_grids=zim_lu)
    inductance_scale = 1e-5
    zm = np.zeros((len(frequencies), n), dtype=complex)
    if fit_inductance:
        zm[:, special_qp_params["inductance"]["index"]] = \
            mat1d.construct_inductance_impedance_vector(frequencies) * inductance_scale
    if fit_ohmic:
        zm[:, special_qp_params["R_inf"]["index"]] = 1
    zm[:, ns:] = zm_drt
    rzm = np.vstack([zm.real, zm.imag])

    # Penalty matrices with the special parameters' diagonal penalties
    # (ohmic_penalty = inductance_penalty = 1e-6, drt.py:879-880)
    m_stack = np.zeros((3, n, n))
    for k in range(3):
        m_stack[k, ns:, ns:] = mat1d.construct_integrated_derivative_matrix(
            np.log(basis_tau), order=k, epsilon=tau_epsilon)
        for sp in special_qp_params.values():
            m_stack[k, sp["index"], sp["index"]] = 1e-6

    vmm = mat1d.construct_eis_var_matrix(frequencies, 0.25, 0.25, None)

    l1v = np.zeros(n)
    l1v[ns:] = hypers["l1_lambda_0"]
    lb = _make_lower_bound(n, nonneg, special_qp_params)

    iw_hypers = dict(hypers)
    iw_hypers["l1_lambda_0"] = iw_l1_lambda_0
    iw_hypers["l2_lambda_0"] = iw_l2_lambda_0

    cfg = QPHBConfig(num_special=ns, k_range=len(hypers["derivative_weights"]),
                     eff_hp=True, has_outlier=False)
    return {
        "frequencies": frequencies, "rzm": rzm, "vmm": vmm, "m_stack": m_stack,
        "l1v": l1v, "lb": lb,
        "hypers": hypers, "iw_hypers": iw_hypers, "cfg": cfg,
        "special_qp_params": special_qp_params, "basis_tau": basis_tau,
        "tau_epsilon": float(tau_epsilon), "inductance_scale": inductance_scale,
        "tau_supergrid": tau_supergrid,
    }
