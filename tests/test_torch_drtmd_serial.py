"""Port parity: the map's serial fit and its posterior readouts
(hybdrt_torch/mapping/drtmd.py::DRTMD: ``fit_all()``, ``fit_observation``,
``add_observation(fit=True)``, ``estimate_obs_drt_var``, ``predict_*_cov``,
``predict_*_var``, ``predict_curv_prob``, ``predict_peak_prob``, the pickles)
against hybdrt_tpu/mapping/drtmd.py::DRTMD on the CPU, float64.

Maps: tests/test_mapping.py's 10 spectra on one grid, and
``probe.small_map("mixed")`` (EIS on two grids and hybrid observations on two
protocols, alternating, so that one ``drt1d`` fits each against its own
matrices), fitted serially by both packages (the readouts of the batched
"eis" and "mixed" maps, the variance of uniform-batched and ragged
observations among them, are held in tests/test_torch_drtmd.py, which fits
those maps). Held: the same tau windows, iteration counts and flags, obs_x and the
special parameters within rtol 1e-6, atol 1e-10, obs_llh and obs_rss within
rtol 1e-8 (separate fits; on one fit state the likelihoods agree to 1e-10,
tests/test_torch_drt_posterior.py); covariances by tests/test_torch_cov.py's bounds
(``probe.cov_bound``, ``probe.variance_errors``); probabilities within what the two
maps' means and variances allow through the normal CDF, point by point
(``probe.prob_bounds``), each bound at most ``probe.PROB_HOLD`` (0.05).
The serial fit's options: ``fit_all(ignore_errors=True)`` with the JAX
package's failure record, ``store_attr_categories`` (each category's
attribute names equal, "detail" among them), and the refusal of nonlinear
configurations (ROADMAP Queue 1 item 9).

The last section holds the reference's default group resolve on the same
fitted maps (one module, so that each map is fitted once), one dense QP a
window (hybdrt_torch/mapping/drtmd.py::DRTMD.resolve_group's default and
``resolve_observations``, mapping/resolve.py::assemble_resolve_system and
``resolve_observations``, the free ``resolve_group(batched=False)``), against
hybdrt_tpu on the CPU, float64.

Each window is ``solve_qp_box`` at one lane, which at these sizes (7 x nc
unknowns, nc = 93) takes the QP's library factor route. Held: the resolved
coefficients and special parameters within rtol 1e-8, atol 1e-10 of the JAX
package's, and each window's interior-point iterations equal to the JAX
dense solve's (its ``solve_qp_box`` on its own assembled window, recorded
as the JAX resolve solves it); on the tests/test_mapping.py map, its first
seven observations, one window, as the mixed map's eight take two. The dense
path against the port's ``batched=True``: within the same bound on the
tests/test_mapping.py map, as the JAX package holds its own
(tests/test_mapping.py:307-316). On the mixed map (hybrid observations) the
two forms stop at different points of a flat optimum, in both packages
alike (ROADMAP Queue 3 item 16): there the port's difference between them
is held to the JAX package's, and their objectives to 1e-12 of |f|.
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping import resolve as jax_resolve
from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch.mapping import resolve
from hybdrt_torch.mapping.drtmd import DRTMD, resolve_group, resolve_windows
from hybdrt_torch.ops import basis as basis_mod, chol_lane
from hybdrt_torch.parallel.batch import BatchedEISFitter
from hybdrt_torch.solver.qphb import QPHBConfig
from hybdrt_torch.utils import probe

import serial_maps

torch.set_num_threads(1)

# the maps (tests/serial_maps.py)
FREQ, TAU_SUPER, PSIS = serial_maps.FREQ, serial_maps.TAU_SUPER, serial_maps.PSIS
_ten_spectra, _observations = serial_maps.ten_spectra, serial_maps.observations
_pair = serial_maps.pair


@pytest.fixture(scope="module")
def serial():
    out = {}
    for kind in ("ten", "mixed"):
        mj, mt = _pair(kind)
        mj.fit_all()
        mt.fit_all()
        out[kind] = (mj, mt)
    return out


def _p(attr):
    return np.asarray(attr["qphb_params"]["p_matrix"])


@pytest.mark.parametrize("kind", ["ten", "mixed"])
def test_serial_fit_matches_jax(serial, kind):
    mj, mt = serial[kind]
    assert mt.obs_fit_status.all() and mj.obs_fit_status.all()
    assert mt.obs_tau_indices == mj.obs_tau_indices
    for at, aj in zip(mt.obs_fit_attr, mj.obs_fit_attr):
        assert at["qphb_params"]["n_iter"] == aj["qphb_params"]["n_iter"]
        assert at["qphb_params"]["converged"] == aj["qphb_params"]["converged"]
        assert at["fit_type"] == aj["fit_type"]
    np.testing.assert_allclose(mt.obs_x, mj.obs_x, rtol=1e-6, atol=1e-10)
    assert set(mt.obs_special) == set(mj.obs_special)
    for key in mj.obs_special:
        np.testing.assert_allclose(mt.obs_special[key], mj.obs_special[key], rtol=1e-6,
                                   atol=1e-10)
    np.testing.assert_allclose(mt.obs_llh, mj.obs_llh, rtol=1e-8)
    np.testing.assert_allclose(mt.obs_rss, mj.obs_rss, rtol=1e-8)


@pytest.mark.parametrize("kind", ["ten", "mixed"])
def test_serial_drt_var_matches_jax(serial, kind):
    """obs_drt_var, stored by the serial fit: each supergrid point within its
    readout bound (the extrapolated points within their reference point's)."""
    mj, mt = serial[kind]
    for i in range(mt.num_obs):
        at, aj = mt.obs_fit_attr[i], mj.obs_fit_attr[i]
        basis = np.asarray(at["basis_tau"])
        em = basis_mod.func_eval_matrix_host(np.log(basis), np.log(mt.tau_supergrid),
                                             "gaussian", at["tau_epsilon"], 0)
        ns = len(_p(at)) - len(basis)
        err, bound = probe.variance_errors(mt.obs_drt_var[i], mj.obs_drt_var[i], _p(at),
                                           _p(aj), em, ns, mt.tau_supergrid, basis)
        assert np.all(err <= bound + 1e-12), (i, err.max())
        assert np.all(mt.obs_drt_var[i] > 0)


def test_mapping_trends(serial):
    """tests/test_mapping.py:38-52 through the port."""
    _, md = serial["ten"]
    rp = md.predict_r_p()
    assert np.max(np.abs(rp - (1.0 + 0.5 * PSIS))) < 0.05
    assert np.max(np.abs(md.obs_special["R_inf"] - (0.3 + 0.2 * PSIS))) < 0.05
    assert md.obs_x.shape == (10, len(TAU_SUPER))
    peak_tau = TAU_SUPER[np.argmax(md.obs_x, axis=1)]
    assert np.all(np.diff(np.log(peak_tau)) > -0.5)
    assert peak_tau[-1] > 10 * peak_tau[0]


def test_batched_fit_matches_serial(serial):
    """tests/test_mapping.py:66-77 through the port."""
    _, md = serial["ten"]
    _, md2 = _pair("ten")
    md2.fit_all(batched=True)
    assert md2.obs_fit_status.all()
    assert np.allclose(md2.obs_x, md.obs_x, atol=1e-7)
    md2.resolve_group("g", psi_sort_dims=["T"])
    assert md2.obs_resolve_status.all()


def test_add_observation_fit(serial):
    """add_observation(fit=True) fits at once: the serial fit_all's values
    bit for bit."""
    _, md = serial["mixed"]
    tau, obs = _observations("mixed")
    m2 = DRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, device="cpu")
    for psi, c, e in obs:
        m2.add_observation(psi, c, e, group_id="g", fit=True)
    assert m2.obs_fit_status.all()
    np.testing.assert_array_equal(m2.obs_x, md.obs_x)
    np.testing.assert_array_equal(m2.obs_drt_var, md.obs_drt_var)
    for key in md.obs_special:
        np.testing.assert_array_equal(m2.obs_special[key], md.obs_special[key])


def _hold_convergence_summary(mj, mt):
    sj, st = mj.fit_convergence_summary(), mt.fit_convergence_summary()
    for k in ("converged", "n_iter"):
        np.testing.assert_array_equal(st[k], sj[k])
    for k in ("num_fitted", "num_failed", "num_converged", "errors"):
        assert st[k] == sj[k]


def test_fit_convergence_summary(serial):
    """The serial mixed map's (the batched maps' are held in
    tests/test_torch_drtmd.py)."""
    _hold_convergence_summary(*serial["mixed"])


@pytest.mark.parametrize("kind", ["ten", "mixed"])
def test_get_fit_of_a_serial_fit(serial, kind):
    """get_fit rebuilds the DRT from its stored attributes (the JAX
    package's DRT(interpolate_integrals=False) with interp is the port's
    default): its predictions and likelihoods match the JAX rebuild's."""
    mj, mt = serial[kind]
    fits = mt.get_fits_batched(np.arange(mt.num_obs))
    for i in range(mt.num_obs):
        dt, dj = fits[i], mj.get_fit(i)
        assert dt.integrate_method == dj.integrate_method == "interp"
        assert dt.evaluate_llh() == pytest.approx(mt.obs_llh[i], rel=1e-12)
        assert dt.evaluate_rss() == pytest.approx(dj.evaluate_rss(), rel=1e-8)
        f = dt.get_fit_frequencies()
        np.testing.assert_allclose(dt.predict_z(f), dj.predict_z(f), rtol=1e-6, atol=1e-10)
        if len(dt.get_fit_times()):
            np.testing.assert_allclose(dt.predict_response(), dj.predict_response(),
                                       rtol=1e-6, atol=1e-10)


def _walk(obj, fn):
    if isinstance(obj, dict):
        return any(_walk(v, fn) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_walk(v, fn) for v in obj)
    return fn(obj)


def test_port_pickle_loads_in_jax(serial, tmp_path):
    """A port-written serial map holds no torch tensor, and the JAX package
    loads it: the same arrays, and the JAX DRT rebuilt from each stored fit
    reads the port's likelihoods on the same state within 1e-10."""
    _, mt = serial["mixed"]
    path = tmp_path / "port.pkl"
    mt.save_attributes(path)
    with open(path, "rb") as f:
        att = pickle.load(f)
    assert not _walk(att, lambda o: isinstance(o, torch.Tensor))
    mj = JaxDRTMD.from_source(str(path))
    np.testing.assert_array_equal(mj.obs_x, mt.obs_x)
    np.testing.assert_array_equal(mj.obs_drt_var, mt.obs_drt_var)
    for i in range(mt.num_obs):
        dj = mj.get_fit(i)
        assert dj.evaluate_llh() == pytest.approx(mt.obs_llh[i], rel=1e-10)
        assert dj.evaluate_rss() == pytest.approx(mt.obs_rss[i], rel=1e-10)
    assert np.isfinite(mj.get_fit(2).evaluate_lml())


@pytest.fixture(scope="module")
def jax_free(serial, tmp_path_factory):
    """The two pickle reads below, each a script run in one process without
    JAX (``serial_maps.jax_free_run``): {name: (ok, output, traceback)} and
    the JAX map's resolve as that process wrote it."""
    mj, _ = serial["mixed"]
    tmp = tmp_path_factory.mktemp("jax_free")
    # a JAX-written serial map
    path = tmp / "jax.pkl"
    mj.save_attributes(str(path))
    out_path = tmp / "out.npz"
    # a JAX array in a pickle, and another JAX object
    att = mj.get_attributes()
    att["obs_fit_attr"] = list(att["obs_fit_attr"])
    att["obs_fit_attr"][3] = dict(att["obs_fit_attr"][3])
    att["obs_fit_attr"][3]["qphb_params"] = dict(att["obs_fit_attr"][3]["qphb_params"],
                                                 x_raw=jnp.asarray([1.0, 2.0]))
    array_path = tmp / "jax_array.pkl"
    with open(array_path, "wb") as f:
        pickle.dump(att, f)
    att["obs_fit_attr"][4] = dict(att["obs_fit_attr"][4], qphb_history=[{"dtype": jnp.float32}])
    other_path = tmp / "jax_object.pkl"
    with open(other_path, "wb") as f:
        pickle.dump(att, f)
    head = "import numpy as np\nfrom hybdrt_torch.mapping.drtmd import DRTMD\n"
    parts = {
        "serial_pickle": head + (
            f"md = DRTMD.from_source({str(path)!r}, device='cpu')\n"
            "from hybdrt_torch.solver.qphb import QPHBConfig\n"
            "assert all(isinstance(a['qphb_params']['cfg'], QPHBConfig) for a in md.obs_fit_attr)\n"
            "llh = [md.get_fit(i).evaluate_llh() for i in range(md.num_obs)]\n"
            "md.resolve_group('g', psi_sort_dims=['T'])\n"
            f"np.savez({str(out_path)!r}, x=md.obs_x, llh=llh, xr=md.obs_x_resolved)\n"),
        "jax_array": head + (
            f"md = DRTMD.from_source({str(array_path)!r}, device='cpu')\n"
            "x = md.obs_fit_attr[3]['qphb_params']['x_raw']\n"
            "assert type(x) is np.ndarray and x.tolist() == [1.0, 2.0], x\n"
            "try:\n"
            f"    DRTMD.from_source({str(other_path)!r}, device='cpu')\n"
            "except ValueError as err:\n"
            "    print(err)\n")}
    return serial_maps.jax_free_run(parts, tmp), out_path


def test_jax_pickle_loads_without_jax(serial, jax_free):
    """A JAX-written serial map pickles the JAX package's QPHBConfig in each
    fit's qphb_params: the port reads it as its own where JAX is absent, and
    the map rebuilds, reads and resolves there."""
    mj, mt = serial["mixed"]
    runs, out_path = jax_free
    ok, _, err = runs["serial_pickle"]
    assert ok, err[-2000:]
    out = np.load(out_path)
    np.testing.assert_array_equal(out["x"], mj.obs_x)
    np.testing.assert_allclose(out["llh"], mj.obs_llh, rtol=1e-10)
    assert np.all(np.isfinite(out["xr"])) and out["xr"].any()
    cfg = mt.obs_fit_attr[0]["qphb_params"]["cfg"]
    assert isinstance(cfg, QPHBConfig) and not cfg.nonlin


def test_jax_array_in_a_pickle_is_named(jax_free):
    """Without JAX a JAX array in a pickle (a "detail" history holds them)
    is read as the numpy array it holds; any other JAX object raises,
    naming the attribute that holds it (ROADMAP Queue 3 item 15)."""
    ok, stdout, err = jax_free[0]["jax_array"]
    assert ok, err[-2000:]
    assert "obs_fit_attr" in stdout and "[4]['qphb_history'][0]['dtype']" in stdout
    assert "Queue 3 item 15" in stdout


# ---------------------------------------------------------------------------
# The serial fit's options
# ---------------------------------------------------------------------------
def test_ignore_errors():
    """tests/test_mapping.py:97-104 through the port, with the JAX
    package's failure record."""
    outs = []
    for cls, kw in ((JaxDRTMD, {}), (DRTMD, {"device": "cpu"})):
        md = cls(TAU_SUPER, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
        md.add_observation([0.0], None, (FREQ, _ten_spectra()[0]))
        md.add_observation([1.0], None, (FREQ[:5], np.full(5, np.nan + 0j)))
        md.fit_all(ignore_errors=True)
        assert md.obs_fit_status[0] and not md.obs_fit_status[1]
        assert md.obs_ignore_flag[1]
        outs.append(md)
    mj, mt = outs
    sj, st = mj.fit_convergence_summary(), mt.fit_convergence_summary()
    for k in ("converged", "n_iter"):
        np.testing.assert_array_equal(st[k], sj[k])
    for k in ("num_fitted", "num_failed", "num_converged"):
        assert st[k] == sj[k]
    assert st["errors"][0] is None and st["errors"][1] is not None
    assert mt.predict_param_cov([0, 1])[1] is None
    assert np.isnan(mt.predict_x_cov([1])).all() and np.isnan(mt.predict_drt_var([1])).all()
    with pytest.raises(ValueError):
        mt.get_fit(1)


@pytest.mark.parametrize("cats", [["config"], ["fit_core"], ["config", "fit_core"],
                                  ["config", "detail"]])
def test_store_attr_categories(cats):
    tau, obs = _observations("eis")
    keys = []
    for cls, kw in ((JaxDRTMD, {}), (DRTMD, {"device": "cpu"})):
        md = cls(tau, store_attr_categories=cats, warn=False, print_progress=False, **kw)
        md.add_observation(*obs[0], fit=True)
        keys.append(set(md.obs_fit_attr[0]))
    assert keys[0] == keys[1]


def test_nonlinear_configuration_refused():
    """A nonlinear configuration, the port's or the JAX package's read from
    a pickle or a ragged system, raises (ROADMAP Queue 1 item 9)."""
    from hybdrt_tpu.solver.qphb import QPHBConfig as JaxQPHBConfig
    from hybdrt_torch.mapping.drtmd import _JaxQPHBConfig
    from hybdrt_torch.parallel.ragged import _port_system
    jcfg = JaxQPHBConfig(num_special=2, nonlin=True, half_size=3)
    for make in (lambda: QPHBConfig(num_special=2, nonlin=True),
                 lambda: QPHBConfig(num_special=2, half_size=3),
                 lambda: _JaxQPHBConfig(*jcfg),
                 lambda: _port_system({"data_type": "eis", "cfg": jcfg}),
                 lambda: _port_system({"data_type": "eis", "cfg": jcfg._asdict()})):
        with pytest.raises(NotImplementedError, match=r"item 9(?!\d)"):
            make()
    assert _port_system({"data_type": "eis", "cfg": jcfg._replace(
        nonlin=False, half_size=0)})["cfg"] == QPHBConfig(num_special=2)


# ---------------------------------------------------------------------------
# The readouts (the variance of batched fits is held in
# tests/test_torch_drtmd.py, on its batched maps)
# ---------------------------------------------------------------------------
def test_serial_drt_var_is_kept(serial):
    _, mt = serial["mixed"]
    before = mt.obs_drt_var.copy()
    mt.estimate_obs_drt_var(refresh=True)
    np.testing.assert_array_equal(mt.obs_drt_var, before)


def _hold_param_and_x_cov(mj, mt):
    idx = [0, 2, 5]
    cov_t, cov_j = mt.predict_param_cov(idx), mj.predict_param_cov(idx)
    xv_t, xv_j = mt.predict_x_var(idx), np.asarray(mj.predict_x_var(idx))
    xc_t, xc_j = mt.predict_x_cov(idx), np.asarray(mj.predict_x_cov(idx))
    for k, i in enumerate(idx):
        p_t = np.asarray(mt.get_fit(i).fit_parameters["p_matrix"])
        p_j = np.asarray(mj.get_fit(i).fit_parameters["p_matrix"])
        bound = probe.cov_bound(p_t, p_j)
        cj = np.asarray(cov_j[k])
        assert np.max(np.abs(cov_t[k] - cj)) <= bound * np.max(np.abs(cj))
        assert np.max(np.abs(xc_t[k] - xc_j[k])) <= bound * np.max(np.abs(xc_j[k]))
        li, ri = mt.obs_tau_indices[i]
        ns = len(p_t) - (ri - li)
        err, vb = probe.variance_errors(xv_t[k, li:ri], xv_j[k, li:ri], p_t, p_j,
                                        np.eye(ri - li), ns)
        assert np.all(err <= vb + 1e-12)
        assert np.all(xv_t[k, :li] == 0) and np.all(xv_t[k, ri:] == 0)


def _hold_drt_var_and_probabilities(mj, mt):
    """predict_drt_var at orders 0-2 within the readout bounds;
    predict_curv_prob and predict_peak_prob point by point within what
    the two maps' means and variances allow through the normal CDF
    (``probe.prob_bounds``), a bound at most ``probe.PROB_HOLD`` at every
    point; all in [0, 1]."""
    idx = np.arange(mt.num_obs)
    tau = mt.get_tau_eval(10)
    inputs = probe.map_prob_inputs(mt, mj, idx, tau)
    assert inputs["var_excess"] <= 1e-12
    for kind, fn in (("curv", "predict_curv_prob"), ("peak_prob", "predict_peak_prob")):
        pt = getattr(mt, fn)(obs_index=idx)
        pj = np.asarray(getattr(mj, fn)(obs_index=idx))
        assert pt.shape == pj.shape == (len(idx), len(tau))
        assert np.all((pt >= 0) & (pt <= 1))
        held, excess, _ = probe.held_probabilities(
            pt, pj, probe.prob_bounds(kind, inputs["mus"], inputs["mus_ref"], inputs["var"],
                                      inputs["var_ref"]))
        assert held.all() and excess <= 0, (fn, held.mean(), excess)
    np.testing.assert_array_equal(mt.predict_drt_cov([0])[0].shape, (len(tau), len(tau)))


# the batched mixed map's cases are in tests/test_torch_drtmd.py
@pytest.mark.parametrize("which", ["ten", "mixed"])
def test_param_and_x_cov(serial, which):
    _hold_param_and_x_cov(*serial[which])


@pytest.mark.parametrize("which", ["ten", "mixed"])
def test_drt_var_and_probabilities(serial, which):
    _hold_drt_var_and_probabilities(*serial[which])


# ---------------------------------------------------------------------------
# The reference's default group resolve: one dense QP a window
# ---------------------------------------------------------------------------
RES_RTOL, RES_ATOL = 1e-8, 1e-10


@pytest.fixture(scope="module")
def maps(serial):
    """The serially fitted "ten" and "mixed" maps."""
    return serial


def _resolved(md, **kw):
    md = copy.deepcopy(md)
    md.resolve_group("g", psi_sort_dims=["T"], **kw)
    return md


def _first_seven(md):
    """A copy of ``md`` whose group "g" holds its first seven observations,
    one window of the default resolve, and the rest another group."""
    md = copy.deepcopy(md)
    md.obs_group_id = ["g" if i < 7 else "rest" for i in range(md.num_obs)]
    return md


def _resolved_jax(mj, monkeypatch):
    """The JAX map resolved, and the IP iterations of each dense window's
    ``solve_qp_box`` in that resolve, recorded as it solves them."""
    iterations, solve = [], jax_resolve.solve_qp_box

    def recorded(*args, **kwargs):
        res = solve(*args, **kwargs)
        iterations.append(int(res.iterations))
        return res

    monkeypatch.setattr(jax_resolve, "solve_qp_box", recorded)
    rj = _resolved(mj)
    monkeypatch.undo()
    return rj, np.array(iterations)


def _hold_default_resolve(mj, mt, monkeypatch):
    rj, jax_iterations = _resolved_jax(mj, monkeypatch)
    chol_lane.reset_launch_counts()
    rt = _resolved(mt)
    info = rt.resolve_info
    assert info["dense"] and not info["coupled"]
    group = mt.get_group_index("g")
    assert rt.obs_resolve_status[group].all()
    np.testing.assert_array_equal(rt.obs_resolve_status, rj.obs_resolve_status)
    np.testing.assert_allclose(rt.obs_x_resolved, rj.obs_x_resolved, rtol=RES_RTOL, atol=RES_ATOL)
    for key in rj.obs_special_resolved:
        np.testing.assert_allclose(rt.obs_special_resolved[key], rj.obs_special_resolved[key],
                                   rtol=RES_RTOL, atol=RES_ATOL)
    np.testing.assert_array_equal(info["n_iter"], jax_iterations)
    # every window's QP took the library route
    assert chol_lane.QP_ROUTES == {"lane": 0, "library": info["windows"], "fused_plain": 0}
    assert info["windows"] == len(resolve_windows(len(group), 7, 2))


# the batched "eis" map's case is in tests/test_torch_drtmd.py
@pytest.mark.parametrize("kind", ["ten", "mixed"])
def test_default_resolve_matches_jax(maps, kind, monkeypatch):
    """The "ten" case resolves the map's first seven observations, one
    window (the mixed map's eight observations take two)."""
    mj, mt = maps[kind]
    if kind == "ten":
        mj, mt = _first_seven(mj), _first_seven(mt)
    _hold_default_resolve(mj, mt, monkeypatch)


def test_dense_matches_batched(maps):
    """tests/test_mapping.py:307-316 through the port: the windows solved
    together, matrix-free, against the dense windows."""
    _, mt = maps["ten"]
    dense, batch = _resolved(mt), _resolved(mt, batched=True)
    np.testing.assert_allclose(batch.obs_x_resolved, dense.obs_x_resolved, rtol=RES_RTOL, atol=RES_ATOL)
    for key in dense.obs_special_resolved:
        np.testing.assert_allclose(batch.obs_special_resolved[key],
                                   dense.obs_special_resolved[key], rtol=RES_RTOL, atol=RES_ATOL)


def test_dense_and_batched_differ_as_in_jax(maps):
    """The mixed map: dense and batched windows land at different points of
    a flat optimum in both packages; the port's gap is the JAX package's,
    and the two objectives agree to 1e-12 of |f| (Queue 3 item 16)."""
    mj, mt = maps["mixed"]
    gap_j = _resolved(mj, batched=True).obs_x_resolved - _resolved(mj).obs_x_resolved
    dense, batch = _resolved(mt), _resolved(mt, batched=True)
    gap_t = batch.obs_x_resolved - dense.obs_x_resolved
    scale = np.max(np.abs(dense.obs_x_resolved))
    assert np.max(np.abs(gap_t - gap_j)) <= 1e-6 * scale
    f_dense = dense.group_objective("g", psi_sort_dims=["T"])
    f_batch = batch.group_objective("g", psi_sort_dims=["T"])
    assert abs(f_dense - f_batch) <= 1e-12 * abs(f_dense)


def test_resolve_observations_one_window(maps):
    """DRTMD.resolve_observations on the first seven observations, and
    resolve.resolve_observations on their DRTs, against the JAX package's."""
    mj, mt = maps["mixed"]
    idx = np.arange(7)
    rj, rt = copy.deepcopy(mj), copy.deepcopy(mt)
    rj.resolve_observations(idx, psi_sort_dims=["T"])
    rt.resolve_observations(idx, psi_sort_dims=["T"])
    np.testing.assert_allclose(rt.obs_x_resolved, rj.obs_x_resolved, rtol=RES_RTOL, atol=RES_ATOL)
    assert rt.obs_resolve_status[:7].all() and not rt.obs_resolve_status[7:].any()
    fits_t, fits_j = mt.get_fits_batched(idx), mj.get_fits_batched(idx)
    tau_idx = [mt.obs_tau_indices[i] for i in idx]
    xt, st, mti = resolve.resolve_observations([fits_t[i] for i in idx], tau_idx, True,
                                               unpack=True, device="cpu")
    xj, sj, mtj = jax_resolve.resolve_observations([fits_j[i] for i in idx], tau_idx, True,
                                                   unpack=True)
    assert tuple(mti) == tuple(mtj)
    np.testing.assert_allclose(xt, xj, rtol=RES_RTOL, atol=RES_ATOL)
    for key in sj:
        np.testing.assert_allclose(st[key], sj[key], rtol=RES_RTOL, atol=RES_ATOL)
    x_raw, _ = resolve.resolve_observations([fits_t[i] for i in idx], tau_idx, True,
                                            device="cpu")
    assert x_raw.shape == (7, xt.shape[1] + 2)  # R_inf and inductance first


def test_assemble_resolve_system(maps):
    """The dense window system against the JAX package's assembly on the
    same fits (the JAX DRTs' arrays, read by ``drt_block_inputs``)."""
    mj, mt = maps["mixed"]
    idx = np.arange(1, 8)
    fits_j = mj.get_fits_batched(idx)
    tau_idx = [mt.obs_tau_indices[i] for i in idx]
    cols = resolve.drt_block_inputs([fits_j[i] for i in idx])
    p_t, q_t, lb_t, meta_t = resolve.assemble_resolve_system(
        cols["p_list"], cols["q_list"], cols["coefficient_scale"], cols["r_inf_scaled"],
        tau_idx, cols["special_qp_params"], True, fit_parameters=cols["fit_parameters"],
        scales=cols["scales"])
    p_j, q_j, lb_j, meta_j = jax_resolve.assemble_resolve_system(
        [fits_j[i] for i in idx], tau_idx, True)
    assert meta_t[1:] == tuple(meta_j[1:])
    np.testing.assert_allclose(p_t, p_j, rtol=1e-12, atol=1e-12 * np.max(np.abs(p_j)))
    np.testing.assert_allclose(q_t, q_j, rtol=1e-12, atol=1e-12 * np.max(np.abs(q_j)))
    np.testing.assert_array_equal(lb_t, lb_j)


def test_lone_and_empty_windows(maps):
    _, mt = maps["ten"]
    md = copy.deepcopy(mt)
    md.resolve_observations([4])
    np.testing.assert_array_equal(md.obs_x_resolved[4], md.obs_x[4])
    with pytest.warns(UserWarning, match="No valid observations"):
        md.resolve_observations(np.array([], dtype=int))


def test_free_resolve_group_dense():
    """The free resolve_group(batched=False) on a BatchedEISFitter's map:
    against its batched=True form and against DRTMD's default resolve of
    the same map fitted batched, which stores the same fit."""
    tau, obs = probe.small_map("eis")
    freq = obs[0][2][0]
    zs = np.stack([e[1] for _, _, e in obs])
    psis = np.array([p[0] for p, _, _ in obs])
    fitter = BatchedEISFitter(freq, tau_supergrid=tau, dtype=torch.float64, device="cpu")
    res = fitter.fit(zs)
    dense = resolve_group(fitter, res, zs, psi=psis, batched=False, device="cpu")
    batch = resolve_group(fitter, res, zs, psi=psis, device="cpu")
    assert dense.info["dense"] and len(dense.info["n_iter"]) == dense.info["windows"]
    np.testing.assert_allclose(dense.x, batch.x, rtol=RES_RTOL, atol=RES_ATOL)
    md = DRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, device="cpu")
    for psi, c, e in obs:
        md.add_observation(psi, c, e, group_id="g")
    md.fit_all(batched=True)
    md.resolve_group("g", psi_sort_dims=["T"])
    li, ri = dense.tau_indices
    np.testing.assert_allclose(md.obs_x_resolved[:, li:ri], dense.x, rtol=RES_RTOL, atol=RES_ATOL)
    np.testing.assert_allclose(md.obs_special_resolved["R_inf"], dense.special["R_inf"],
                               rtol=RES_RTOL, atol=RES_ATOL)


def test_remaining_raises(maps):
    _, mt = maps["ten"]
    with pytest.raises(NotImplementedError, match=r"item 10(?!\d)"):
        mt.resolve_group("g", mesh=object())
    with pytest.raises(NotImplementedError, match=r"item 10(?!\d)"):
        mt.fit_all(mesh=object())
