"""Port parity: the DOP through the ragged fitter and the map class
(hybdrt_torch/parallel/ragged.py, mapping/drtmd.py, mapping/resolve.py)
against the JAX package's, float64 on the CPU.

The map is ``probe.small_map("mixed")`` (EIS on two grids, hybrid
observations on two protocols: with DOP both halves go to the ragged
fitter, as in ``hybdrt_tpu/mapping/drtmd.py:535-555``), fitted by both
packages with ``DRTMD(fit_dop=True).fit_all(batched=True)``. Held: the same
iteration counts, obs_x and obs_special["x_dop"] within 1e-6 of each
observation's max |x|; the resolve of the JAX map's fits carried over by
``load_fit_state`` (coupled and windowed), obs_x_resolved and the resolved
x_dop at rtol 1e-6, atol 1e-8 (tests/test_torch_drtmd.py's resolve); the
rebuilt (P, q) at rtol 1e-9 (its rebuild tolerance); ``predict_dop``; and a
JAX DOP map's pickle read without JAX's classes (``load_pickle``).

On the port's fitted map: ``from_systems`` on the JAX DRT's prep-only DOP
systems against the port's own ragged fit of the same observations (the
same iterations, x and x_dop within 1e-6 of max |x|); the map's (P, q)
rebuild with the DOP block's derivative strengths at 1, as both packages
take them (``_uniform_pq`` and ``_ragged_pq_batched`` pass ones,
hybdrt_tpu/mapping/drtmd.py:1064, :1282: ROADMAP Queue 3 item 20);
``fit_dop`` in the fitter cache key (tests/test_mapping.py:593); and
``fit_capacitance``'s C_inv through the map, against the serial fits. One
module holds them all, so that the JAX package compiles the map's DOP
systems once.
"""
import copy

import numpy as np
import pytest
import torch

import hybdrt_tpu
from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch import BatchedRaggedFitter, DRT
from hybdrt_torch.mapping.drtmd import DRTMD, STATE_KEYS, load_fit_state
from hybdrt_torch.solver import qphb as qphb_mod
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

FIT_TOL = 1e-6
RTOL, ATOL = 1e-6, 1e-8


def _build(cls, kind="mixed", **kw):
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
    mj = _build(JaxDRTMD, fit_dop=True)
    mj.fit_all(batched=True)
    mt = _build(DRTMD, fit_dop=True, device="cpu")
    mt.fit_all(batched=True)
    out = {"fit": (mj, mt)}
    for form, kw in (("coupled", {"coupled": True}), ("windowed", {"batched": True})):
        rj = copy.deepcopy(mj)
        rj.resolve_group("g", psi_sort_dims=["T"], **kw)
        rt = load_fit_state(_build(DRTMD, fit_dop=True, device="cpu"), _state(mj))
        rt.resolve_group("g", psi_sort_dims=["T"], **kw)
        out[form] = (rj, rt)
    return out


def test_dop_map_fit_matches_jax(maps):
    mj, mt = maps["fit"]
    assert mt.obs_fit_status.all() and mj.obs_fit_status.all()
    assert {type(f).__name__ for f in mt._fitter_cache.values()} \
        == {type(f).__name__ for f in mj._fitter_cache.values()} == {"BatchedRaggedFitter"}
    assert set(mt.obs_special) == set(mj.obs_special) == {"R_inf", "inductance", "x_dop"}
    for i in range(mt.num_obs):
        assert mt.obs_fit_attr[i]["n_iter"] == mj.obs_fit_attr[i]["n_iter"], i
        xm = np.max(np.abs(mj.obs_x[i]))
        assert np.max(np.abs(mt.obs_x[i] - mj.obs_x[i])) <= FIT_TOL * xm, i
        assert np.max(np.abs(mt.obs_special["x_dop"][i] - mj.obs_special["x_dop"][i])) \
            <= FIT_TOL * xm, i
    np.testing.assert_allclose(mt.obs_rss, mj.obs_rss, rtol=1e-6)


@pytest.mark.parametrize("form", ["coupled", "windowed"])
def test_dop_resolve_matches_jax(maps, form):
    rj, rt = maps[form]
    assert rt.obs_resolve_status.all() == rj.obs_resolve_status.all()
    np.testing.assert_allclose(rt.obs_x_resolved, rj.obs_x_resolved, rtol=RTOL, atol=ATOL)
    assert set(rt.obs_special_resolved) >= {"x_dop", "R_inf"}
    for key in ("x_dop", "R_inf", "inductance"):
        np.testing.assert_allclose(rt.obs_special_resolved[key], rj.obs_special_resolved[key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # the resolve moved the DOP
    assert not np.allclose(rt.obs_special_resolved["x_dop"], rt.obs_special["x_dop"])


@pytest.mark.parametrize("resolved", [False, True])
def test_predict_dop_matches_jax(maps, resolved):
    rj, rt = maps["coupled"]
    nu = np.linspace(-1, 1, 41)
    for kw in ({}, {"nu": nu, "normalize": False}, {"obs_index": [1, 4]},
               {"psi": rt.obs_psi[2]}):
        np.testing.assert_allclose(rt.predict_dop(resolved=resolved, **kw),
                                   rj.predict_dop(resolved=resolved, **kw), rtol=RTOL,
                                   atol=ATOL)
    with pytest.raises(ValueError, match="DOP was not fitted"):
        DRTMD(rt.tau_supergrid, device="cpu").predict_dop()


def test_rebuilt_dop_pq_matches_jax(maps):
    """The rebuild of the JAX map's fits, carried over by load_fit_state,
    against JAX's grouped rebuild."""
    mj, _ = maps["fit"]
    _, mt = maps["coupled"]
    idx = np.arange(mt.num_obs)
    fj, ft = mj.get_fits_batched(idx), mt.get_fits_batched(idx)
    for i in idx:
        for key in ("p_matrix", "q_vector"):
            np.testing.assert_allclose(ft[i].fit_parameters[key],
                                       np.asarray(fj[i].fit_parameters[key]), rtol=1e-9,
                                       atol=1e-11)
        np.testing.assert_allclose(ft[i].fit_parameters["x_dop"],
                                   np.asarray(fj[i].fit_parameters["x_dop"]), rtol=FIT_TOL,
                                   atol=FIT_TOL * np.max(np.abs(mj.obs_x[i])))
        np.testing.assert_allclose(ft[i].dop_scale_vector, fj[i].dop_scale_vector, rtol=1e-12)


def test_jax_dop_map_pickle_loads(maps, tmp_path):
    """A JAX DOP map's attributes, saved by the JAX class and read by the
    port's (load_pickle: its QPHBConfig, DOP fields and x_dop carried),
    predict and resolve as the JAX map does."""
    rj, _ = maps["coupled"]
    path = tmp_path / "dop.pkl"
    rj.save_attributes(str(path))
    md = DRTMD.from_source(str(path), device="cpu")
    assert md.fit_dop and md.obs_special["x_dop"].shape == rj.obs_special["x_dop"].shape
    for resolved in (False, True):
        np.testing.assert_allclose(md.predict_dop(resolved=resolved),
                                   rj.predict_dop(resolved=resolved), rtol=1e-12, atol=1e-15)
    md.resolve_group("g", psi_sort_dims=["T"], coupled=True)
    np.testing.assert_allclose(md.obs_special_resolved["x_dop"], rj.obs_special_resolved["x_dop"],
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def port_map(maps):
    """The port's own DOP fit of the map."""
    return maps["fit"][1]


def test_map_rebuild_takes_unit_dop_rho_as_jax_does(port_map):
    """ROADMAP Queue 3 item 20: the map's (P, q) rebuild takes the DOP
    block's derivative strengths at 1, where the fit's last QP had its own:
    off the DOP block P is the fit's, on it it is not."""
    mt = port_map
    i = 0
    attr = mt.obs_fit_attr[i]
    fitter = mt._get_ragged_fitter()
    obs = [mt.get_obs_data(i)]
    systems, p_map, _ = fitter.posterior(obs, [attr["x_raw"]], [attr["rho"]],
                                         [attr["s_vectors"]], [attr["weights"]])
    state = fitter.fit(obs, return_states=True)[1]
    dop_rho = state.dop_rho_vector
    assert not torch.allclose(dop_rho, torch.ones_like(dop_rho))
    s0 = systems[0]
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)[None]
    p_fit, _ = qphb_mod.calculate_pq(
        t(s0["rzm"])[0], t(s0["rzv"]), t(s0["m_stack"])[0],
        qphb_mod.hypers_to_tensors(s0["hypers"], "cpu", torch.float64),
        t(s0["l1_lambda_vector"])[0], t(attr["rho"]), t(attr["s_vectors"]), t(attr["weights"]),
        s0["cfg"], dop_rho_vector=dop_rho.double())
    p_fit = p_fit[0].numpy()
    ds, de = s0["cfg"].dop_start, s0["cfg"].dop_start + s0["cfg"].dop_size
    mask = np.ones(p_map[0].shape, dtype=bool)
    mask[ds:de, ds:de] = False
    np.testing.assert_allclose(p_map[0][mask], p_fit[mask], rtol=1e-12, atol=1e-12)
    assert np.max(np.abs(p_map[0][ds:de, ds:de] - p_fit[ds:de, ds:de])) > 0


def test_from_systems_takes_jax_dop_systems(port_map):
    """The JAX DRT's prep-only DOP systems through from_systems, against
    the port's ragged fit of the same observations: two EIS observations on
    the map's first grid and its two hybrid observations, one on each
    protocol (one JAX DRT prepares them all: its tables are built once, and
    its assembly cache is keyed by grid and protocol)."""
    mt = port_map
    tau = mt.tau_supergrid
    drt = hybdrt_tpu.DRT(tau_supergrid=tau, fit_dop=True, warn=False)
    for kind in ("eis", "hybrid"):
        obs = []
        for i in range(mt.num_obs):
            c, e = mt.get_obs_data(i)
            hybrid = c is not None and c[0] is not None
            if hybrid != (kind == "hybrid") or len(obs) == 2:
                continue
            if hybrid or not obs or len(e[0]) == len(obs[0][1][0]):
                obs.append((c, e))
        assert len(obs) == 2
        systems = []
        for c, e in obs:
            t, i_s, v = c if c is not None else (None, None, None)
            systems.append(drt._qphb_fit_core(t, i_s, v, *e, prep_only=True))
        assert systems[0]["cfg"].fit_dop and systems[0]["dop_gmat"] is not None
        res_s = BatchedRaggedFitter.from_systems(systems, tau, device="cpu").fit()
        res_o = BatchedRaggedFitter(tau, fit_dop=True, device="cpu").fit(obs)
        np.testing.assert_array_equal(res_s.n_iter, res_o.n_iter)
        xm = np.max(np.abs(res_o.x))
        np.testing.assert_allclose(res_s.x_dop, res_o.x_dop, rtol=0, atol=FIT_TOL * xm)
        np.testing.assert_allclose(res_s.x, res_o.x, rtol=0, atol=FIT_TOL * xm)


def test_fitter_cache_keyed_by_fit_dop():
    """tests/test_mapping.py:593 on the port: turning fit_dop on between
    fit_all calls builds a new fitter, whose fits carry x_dop."""
    md = _build(DRTMD, kind="eis", device="cpu")
    md.fit_all(batched=True)
    assert len(md._fitter_cache) == 1
    before = next(iter(md._fitter_cache.values()))
    assert not before.cfg.fit_dop
    md.fit_dop = True
    md.drt1d = DRT(tau_supergrid=md.tau_supergrid, fit_dop=True, warn=False, device="cpu")
    md.obs_special = None
    md.fit_all(batched=True, refit=True)
    assert len(md._fitter_cache) == 2
    after = [f for f in md._fitter_cache.values() if f is not before][0]
    assert after.cfg.fit_dop and after.cfg.dop_size == 50
    assert np.all(np.isfinite(md.obs_special["x_dop"])) and md.obs_special["x_dop"].any()


def test_capacitance_through_the_map():
    """DRTMD(fit_capacitance=True): the uniform EIS fitter's C_inv in
    obs_special, as the serial fit of each observation gives it; the
    configuration survives a save and load (tests/test_mapping.py:453)."""
    md = _build(DRTMD, kind="eis", device="cpu", fit_capacitance=True)
    md.fit_all(batched=True)
    assert set(md.obs_special) == {"R_inf", "inductance", "C_inv"}
    for i in (0, 5):
        drt = DRT(tau_supergrid=md.tau_supergrid, fit_capacitance=True, warn=False,
                  device="cpu").fit_eis(*md.get_obs_data(i)[1])
        assert md.obs_special["C_inv"][i] == pytest.approx(drt.fit_parameters["C_inv"],
                                                           rel=1e-6, abs=1e-10)
    md.resolve_group("g", psi_sort_dims=["T"], coupled=True)
    assert np.all(np.isfinite(md.obs_special_resolved["C_inv"]))
    att = md.get_attributes("config")
    md2 = DRTMD.from_source(dict(att, step_model="expdecay"), device="cpu")
    assert md2.fit_capacitance and md2.step_model == "expdecay"
