"""Port parity: DRTMD's (P, q) rebuild (``get_fits_batched``) and group
resolve (``resolve_group``, windowed and coupled) against
hybdrt_tpu/mapping/drtmd.py::DRTMD on the CPU, float64.

The rebuild is held to the JAX package's grouped rebuild at
tests/test_get_fits_batched.py:43's tolerances (rtol 1e-9, atol 1e-11). The
resolve runs on the JAX map's own fits, carried into the port's map by
``load_fit_state``, and is held to JAX's at rtol 1e-6, atol 1e-8, on the
uniform EIS map and on the mixed map (EIS on two grids, hybrid observations'
v_baseline and vz_offset marginalized).

The JAX package's rebuild of a uniform hybrid group puts its template fit's
vz-offset column into every observation's design
(hybdrt_tpu/mapping/drtmd.py:1046-1068 reads the template's ``rm``), where
the fit's last QP had the observation's own; the port puts each
observation's own there, as the JAX package's ragged rebuild does
(:1293-1312). ``test_uniform_hybrid_pq_departs_only_in_the_vz_column`` pins
the difference (ROADMAP Queue 3 item 13).
"""
import warnings

import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_tpu.models.drt import _hypers_to_pytree
from hybdrt_tpu.solver import qphb as jax_qphb
from hybdrt_torch.mapping.drtmd import DRTMD, STATE_KEYS, load_fit_state
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11


def _build(kind, cls, **kw):
    tau, obs = probe.small_map(kind)
    md = cls(tau, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
    for psi, c, e in obs:
        md.add_observation(psi, c, e, group_id="g")
    return md


def _state(md):
    """A JAX map's fit state as numpy arrays and plain values."""
    def plain(v):
        if isinstance(v, dict):
            return {k: plain(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(plain(u) for u in v)
        if v is None or isinstance(v, (bool, int, float, str, np.ndarray)):
            return v
        return np.asarray(v)
    return {k: plain(getattr(md, k)) for k in STATE_KEYS}


@pytest.fixture(scope="module")
def maps():
    out = {}
    for kind in ("mixed", "eis", "hybrid"):
        mj = _build(kind, JaxDRTMD)
        mj.fit_all(batched=True)
        mt = _build(kind, DRTMD, device="cpu")
        mt.fit_all(batched=True)
        out[kind] = (mj, mt)
    return out


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["mixed", "eis"])
def test_grouped_pq_matches_jax(maps, kind):
    """The rebuild of the JAX map's fits, carried over by ``load_fit_state``
    (the uniform map's fitter rebuilt from the observations' grids), against
    JAX's grouped rebuild."""
    mj, _ = maps[kind]
    mt = load_fit_state(_build(kind, DRTMD, device="cpu"), _state(mj))
    idx = np.arange(mt.num_obs)
    gj, gt = mj.get_fits_batched(idx), mt.get_fits_batched(idx)
    assert set(gt) == set(idx)
    for i in idx:
        for key in ("p_matrix", "q_vector", "x"):
            _close(gt[i].fit_parameters[key], gj[i].fit_parameters[key])
        for key in ("R_inf", "inductance", "vz_offset", "v_baseline"):
            if key in gj[i].fit_parameters:
                np.testing.assert_allclose(gt[i].fit_parameters[key],
                                           gj[i].fit_parameters[key], rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize("kind", ["mixed", "eis"])
def test_grouped_pq_of_own_fits_tracks_jax(maps, kind):
    """Each package's rebuild of its own fits, which agree to ~1e-11 of
    max |x| (tests/test_torch_drtmd.py), within the fits' rtol 1e-6."""
    mj, mt = maps[kind]
    idx = np.arange(mt.num_obs)
    gj, gt = mj.get_fits_batched(idx), mt.get_fits_batched(idx)
    for i in idx:
        for key in ("p_matrix", "q_vector"):
            ref = gj[i].fit_parameters[key]
            np.testing.assert_allclose(gt[i].fit_parameters[key], ref, rtol=1e-6,
                                       atol=1e-6 * np.max(np.abs(ref)))


def test_ragged_pq_matches_one_rebuilt_alone(maps):
    """tests/test_get_fits_batched.py:141: the per-protocol rebuild gives
    every observation the (P, q) it gets rebuilt alone, EIS and hybrid."""
    _, mt = maps["mixed"]
    grouped = mt.get_fits_batched(np.arange(mt.num_obs))
    assert all(mt.obs_fit_attr[i]["ragged"] for i in range(mt.num_obs))
    for i in range(mt.num_obs):
        one = mt.get_fit(i)
        for key in ("p_matrix", "q_vector"):
            np.testing.assert_allclose(grouped[i].fit_parameters[key],
                                       one.fit_parameters[key], rtol=1e-12, atol=1e-14)


def test_uniform_hybrid_pq_departs_only_in_the_vz_column(maps):
    """Off the vz-offset row and column, (P, q) is JAX's; on them it is
    JAX's calculate_pq with each observation's own final vz-offset column in
    its design, the column the fit's last QP had."""
    mj, mt = maps["hybrid"]
    idx = np.arange(mt.num_obs)
    gj, gt = mj.get_fits_batched(idx), mt.get_fits_batched(idx)
    fj = mj._batch_fitter
    qp = fj.template.qphb_params
    vz, nc = fj.vz_index, fj.num_chrono
    rzm_vz, strength = np.asarray(fj.rzm_vz), np.asarray(fj.vz_strength_vec)
    for i in idx:
        pj, qj = gj[i].fit_parameters["p_matrix"], gj[i].fit_parameters["q_vector"]
        pt, qt = gt[i].fit_parameters["p_matrix"], gt[i].fit_parameters["q_vector"]
        off = np.ones(pj.shape, dtype=bool)
        off[vz, :] = off[:, vz] = False
        np.testing.assert_allclose(pt[off], pj[off], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.delete(qt, vz), np.delete(qj, vz), rtol=RTOL, atol=ATOL)
        assert np.max(np.abs(pt[vz] - pj[vz])) > 1e-3 * np.max(np.abs(pj[vz]))
        attr = mj.obs_fit_attr[i]
        x = np.asarray(attr["x_raw"])
        sign = np.where(np.arange(rzm_vz.shape[0]) < nc, 1.0, -1.0)
        rzm = np.array(qp["rm"], dtype=float)
        rzm[:, vz] = (rzm_vz @ x) * sign * strength
        p_ref, q_ref = jax_qphb.calculate_pq(
            rzm, np.asarray(attr["rzv"]),
            np.stack([qp["penalty_matrices"][f"m{k}"] for k in range(3)]),
            _hypers_to_pytree(qp["hypers"]), np.asarray(qp["l1_lambda_vector"]),
            np.asarray(attr["rho"]), np.ones(3), np.asarray(attr["s_vectors"]),
            np.asarray(attr["weights"]), qp["cfg"])
        np.testing.assert_allclose(pt, np.asarray(p_ref), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(qt, np.asarray(q_ref), rtol=RTOL, atol=ATOL)


def _resolve_both(kind, maps, kw):
    mj, _ = maps[kind]
    mt = load_fit_state(_build(kind, DRTMD, device="cpu"), _state(mj))
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        mj.resolve_group("g", psi_sort_dims=["T"], **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        mt.resolve_group("g", psi_sort_dims=["T"], **kw)
    kkt = lambda ws: [w for w in ws if "did not fully converge" in str(w.message)]
    return mj, mt, bool(kkt(wj)), bool(kkt(wt))


CASES = {
    "eis-coupled": ("eis", {"coupled": True}),
    "eis-windowed": ("eis", {"batched": True}),
    "eis-windowed-4-1": ("eis", {"batched": True, "batch_size": 4, "overlap": 1}),
    "mixed-coupled": ("mixed", {"coupled": True}),
    "mixed-windowed": ("mixed", {"batched": True}),
    "mixed-windowed-4-1": ("mixed", {"batched": True, "batch_size": 4, "overlap": 1}),
    "mixed-windowed-truncate": ("mixed", {"batched": True, "batch_size": 4, "overlap": 1,
                                          "truncate": True}),
    "mixed-coupled-tau-filter": ("mixed", {"coupled": True, "tau_filter_sigma": 1.0,
                                           "sigma": 2.0, "lambda_psi": 3.0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resolve_matches_jax(maps, case):
    kind, kw = CASES[case]
    mj, mt, warn_j, warn_t = _resolve_both(kind, maps, kw)
    assert warn_t == warn_j
    np.testing.assert_array_equal(mt.obs_resolve_status, mj.obs_resolve_status)
    np.testing.assert_allclose(mt.obs_x_resolved, mj.obs_x_resolved, rtol=1e-6, atol=1e-8)
    assert set(mt.obs_special_resolved) == set(mj.obs_special_resolved)
    for key, val in mj.obs_special_resolved.items():
        np.testing.assert_allclose(mt.obs_special_resolved[key], val, rtol=1e-6, atol=1e-8)
    if kw.get("coupled"):
        assert mt.resolve_info["n_iter"] == mj.resolve_info["n_iter"]
        np.testing.assert_allclose(mt.resolve_info["kkt_tol"], mj.resolve_info["kkt_tol"],
                                   rtol=1e-9)
    for key in ("rebuild_s", "assembly_s", "solve_s"):
        assert mt.resolve_info[key] >= 0


def test_special_filter_sigma_changes_nothing_without_dop(maps):
    """special_filter_sigma smooths only the DOP block (hybdrt_tpu/mapping/
    resolve.py:180-186), which no ported fit has."""
    _, mt = maps["mixed"]
    out = []
    for sfs in (0, 1.5):
        mt.resolve_group("g", psi_sort_dims=["T"], batched=True, special_filter_sigma=sfs)
        out.append(mt.obs_x_resolved.copy())
    np.testing.assert_array_equal(out[0], out[1])


def test_coupled_objective_is_no_higher_than_windowed(maps):
    _, mt = maps["mixed"]
    obj = {}
    for label, kw in (("windowed", {"batched": True}), ("coupled", {"coupled": True})):
        mt.resolve_group("g", psi_sort_dims=["T"], **kw)
        obj[label] = mt.group_objective("g", psi_sort_dims=["T"])
    assert obj["coupled"] <= obj["windowed"]


def test_resolve_on_the_ports_own_fits(maps):
    """The port's resolve of its own fits lands where JAX's does of JAX's
    (the fits agree to ~1e-11)."""
    mj, mt = maps["mixed"]
    mj.resolve_group("g", psi_sort_dims=["T"], batched=True)
    mt.resolve_group("g", psi_sort_dims=["T"], batched=True)
    np.testing.assert_allclose(mt.obs_x_resolved, mj.obs_x_resolved, rtol=1e-6, atol=1e-8)


def test_load_fit_state_checks_the_map():
    mj = _build("eis", JaxDRTMD)
    md = DRTMD(np.logspace(-7, 2, 71), device="cpu")
    with pytest.raises(ValueError, match="observations"):
        load_fit_state(md, _state(mj))
