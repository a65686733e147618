"""Port parity: the map's serial fit and its posterior readouts
(hybdrt_torch/mapping/drtmd.py::DRTMD: ``fit_all()``, ``fit_observation``,
``add_observation(fit=True)``, ``estimate_obs_drt_var``, ``predict_*_cov``,
``predict_*_var``, ``predict_curv_prob``, ``predict_peak_prob``, the pickles)
against hybdrt_tpu/mapping/drtmd.py::DRTMD on the CPU, float64.

Maps: tests/test_mapping.py's 10 spectra on one grid, and
``probe.small_map("mixed")`` (EIS on two grids and hybrid observations on two
protocols, alternating, so that one ``drt1d`` fits each against its own
matrices), fitted serially by both packages; the "eis" and "mixed" small maps
fitted batched for the variance of uniform-batched and ragged observations.
Held: the same tau windows, iteration counts and flags, obs_x and the
special parameters within rtol 1e-6, atol 1e-10, obs_llh and obs_rss within
rtol 1e-8 (separate fits; on one fit state the likelihoods agree to 1e-10,
tests/test_torch_drt_posterior.py); covariances by tests/test_torch_cov.py's bounds
(``probe.cov_bound``, ``probe.variance_errors``); probabilities within what the two
maps' means and variances allow through the normal CDF, point by point
(``probe.prob_bounds``), each bound at most ``probe.PROB_HOLD`` (0.05).
The serial fit's options (``ignore_errors``, ``store_attr_categories``) and
the refusal of nonlinear configurations are in
tests/test_torch_drtmd_serial_options.py.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch.mapping.drtmd import DRTMD
from hybdrt_torch.ops import basis as basis_mod
from hybdrt_torch.solver.qphb import QPHBConfig
from hybdrt_torch.utils import probe

import serial_maps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the maps (tests/serial_maps.py, with tests/test_torch_resolve_dense.py;
# tests/test_torch_drtmd_serial_options.py imports them from here)
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


@pytest.fixture(scope="module")
def batched():
    out = {}
    for kind in ("eis", "mixed"):
        mj, mt = _pair(kind)
        mj.fit_all(batched=True)
        mt.fit_all(batched=True)
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


def test_fit_convergence_summary(serial, batched):
    for maps in (serial["mixed"], batched["mixed"], batched["eis"]):
        sj, st = (m.fit_convergence_summary() for m in maps)
        for k in ("converged", "n_iter"):
            np.testing.assert_array_equal(st[k], sj[k])
        for k in ("num_fitted", "num_failed", "num_converged", "errors"):
            assert st[k] == sj[k]


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


_JAX_FREE = ("import sys\n"
             "for n in ('jax', 'jaxlib', 'hybdrt_tpu'):\n"
             "    sys.modules[n] = None\n"
             "import numpy as np\n"
             "from hybdrt_torch.mapping.drtmd import DRTMD\n")


def test_jax_pickle_loads_without_jax(serial, tmp_path):
    """A JAX-written serial map pickles the JAX package's QPHBConfig in each
    fit's qphb_params: the port reads it as its own where JAX is absent, and
    the map rebuilds, reads and resolves there."""
    mj, mt = serial["mixed"]
    path = tmp_path / "jax.pkl"
    mj.save_attributes(str(path))
    out_path = tmp_path / "out.npz"
    code = _JAX_FREE + (
        f"md = DRTMD.from_source({str(path)!r}, device='cpu')\n"
        "from hybdrt_torch.solver.qphb import QPHBConfig\n"
        "assert all(isinstance(a['qphb_params']['cfg'], QPHBConfig) for a in md.obs_fit_attr)\n"
        "llh = [md.get_fit(i).evaluate_llh() for i in range(md.num_obs)]\n"
        "md.resolve_group('g', psi_sort_dims=['T'])\n"
        f"np.savez({str(out_path)!r}, x=md.obs_x, llh=llh, xr=md.obs_x_resolved)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = np.load(out_path)
    np.testing.assert_array_equal(out["x"], mj.obs_x)
    np.testing.assert_allclose(out["llh"], mj.obs_llh, rtol=1e-10)
    assert np.all(np.isfinite(out["xr"])) and out["xr"].any()
    cfg = mt.obs_fit_attr[0]["qphb_params"]["cfg"]
    assert isinstance(cfg, QPHBConfig) and not cfg.nonlin


def test_jax_array_in_a_pickle_is_named(serial, tmp_path):
    """Without JAX a JAX array in a pickle (a "detail" history holds them)
    is read as the numpy array it holds; any other JAX object raises,
    naming the attribute that holds it (ROADMAP Queue 3 item 15)."""
    mj, _ = serial["mixed"]
    att = mj.get_attributes()
    att["obs_fit_attr"] = list(att["obs_fit_attr"])
    att["obs_fit_attr"][3] = dict(att["obs_fit_attr"][3])
    att["obs_fit_attr"][3]["qphb_params"] = dict(att["obs_fit_attr"][3]["qphb_params"],
                                                 x_raw=jnp.asarray([1.0, 2.0]))
    path = tmp_path / "jax_array.pkl"
    with open(path, "wb") as f:
        pickle.dump(att, f)
    att["obs_fit_attr"][4] = dict(att["obs_fit_attr"][4], qphb_history=[{"dtype": jnp.float32}])
    path_other = tmp_path / "jax_object.pkl"
    with open(path_other, "wb") as f:
        pickle.dump(att, f)
    code = _JAX_FREE + (
        f"md = DRTMD.from_source({str(path)!r}, device='cpu')\n"
        "x = md.obs_fit_attr[3]['qphb_params']['x_raw']\n"
        "assert type(x) is np.ndarray and x.tolist() == [1.0, 2.0], x\n"
        "try:\n"
        f"    DRTMD.from_source({str(path_other)!r}, device='cpu')\n"
        "except ValueError as err:\n"
        "    print(err)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "obs_fit_attr" in res.stdout and "[4]['qphb_history'][0]['dtype']" in res.stdout
    assert "Queue 3 item 15" in res.stdout


# ---------------------------------------------------------------------------
# The variance of batched fits, and the readouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["eis", "mixed"])
def test_estimate_obs_drt_var(batched, kind):
    """Uniform-batched ("eis": one batched inverse) and ragged ("mixed":
    the per-observation path, batched by size of P) observations against
    the JAX package's, each within its readout bound; the uniform group
    path against the port's own per-observation path."""
    mj, mt = batched[kind]
    var_t = mt.estimate_obs_drt_var().copy()
    var_j = np.asarray(mj.estimate_obs_drt_var())
    fits_t = mt.get_fits_batched(np.arange(mt.num_obs))
    for i in range(mt.num_obs):
        dt, dj = fits_t[i], mj.get_fit(i)
        p_t, p_j = (np.asarray(d.fit_parameters["p_matrix"]) for d in (dt, dj))
        em = basis_mod.func_eval_matrix_host(np.log(dt.basis_tau), np.log(mt.tau_supergrid),
                                             "gaussian", dt.tau_epsilon, 0)
        args = (p_t, p_j, em, dt.get_qp_mat_offset(), mt.tau_supergrid, dt.basis_tau)
        err, bound = probe.variance_errors(var_t[i], var_j[i], *args)
        assert np.all(err <= bound + 1e-12), (i, err.max())
        own = np.diag(dt.estimate_distribution_cov(tau=mt.tau_supergrid, extend_var=True))
        err, bound = probe.variance_errors(var_t[i], own, p_t, p_t, *args[2:])
        assert np.all(err <= bound + 1e-12), (i, err.max())
    # stored values are kept unless refreshed; serial fits keep theirs
    mt.obs_drt_var[0] *= 2
    assert np.array_equal(mt.estimate_obs_drt_var()[0], 2 * var_t[0])
    np.testing.assert_allclose(mt.estimate_obs_drt_var(refresh=True)[0], var_t[0], rtol=1e-12)


def test_serial_drt_var_is_kept(serial):
    _, mt = serial["mixed"]
    before = mt.obs_drt_var.copy()
    mt.estimate_obs_drt_var(refresh=True)
    np.testing.assert_array_equal(mt.obs_drt_var, before)


def _readout_maps(serial, batched, which):
    return serial[which] if which in serial else batched[which.split("-")[1]]


@pytest.mark.parametrize("which", ["ten", "mixed", "batched-mixed"])
def test_param_and_x_cov(serial, batched, which):
    mj, mt = _readout_maps(serial, batched, which)
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


@pytest.mark.parametrize("which", ["ten", "mixed", "batched-mixed"])
def test_drt_var_and_probabilities(serial, batched, which):
    """predict_drt_var at orders 0-2 within the readout bounds;
    predict_curv_prob and predict_peak_prob point by point within what
    the two maps' means and variances allow through the normal CDF
    (``probe.prob_bounds``), a bound at most ``probe.PROB_HOLD`` at every
    point; all in [0, 1]."""
    mj, mt = _readout_maps(serial, batched, which)
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
