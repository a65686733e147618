"""Port parity: the map class hybdrt_torch/mapping/drtmd.py::DRTMD, its
batched fits and observation store, against hybdrt_tpu/mapping/drtmd.py::DRTMD
on the CPU, float64.

Three small maps (``utils/probe.py::small_map``): a mixed one (EIS on two
grids, hybrid on two chrono protocols: the ragged fitter), a uniform EIS one
(the shared-grid EIS fitter) and a uniform hybrid one (the shared-protocol
hybrid fitter). Each is fitted by both packages with ``fit_all(batched=True)``
and held to the same tau windows, iteration counts and flags, coefficients
within 1e-6 of each observation's max |x|, and R_inf, inductance, rss and llh
within rtol 1e-6.

The module's later sections hold the batched maps' variance, posterior
readouts and default dense resolve (by tests/test_torch_drtmd_serial.py's
holds, which hold its serial maps' the same way), the rebuild and the
resolve, and the read side, on the same fits (one module, so that each map is fitted once by each
package; each section takes its own deep copy where it resolves in place).

The rebuild and the resolve. Port parity: DRTMD's (P, q) rebuild (``get_fits_batched``) and group
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

The read side. Port parity: the read side of hybdrt_torch/mapping/drtmd.py::DRTMD
(predictions, accessors, filters, QC scores, persistence) against
hybdrt_tpu/mapping/drtmd.py:1590-2069 on the CPU, float64.

The map is ``probe.small_map("mixed")`` (EIS on two grids, hybrid on two
chrono protocols), fitted once by the JAX package and carried into the
port's map with ``load_fit_state``, so the port's fit is not paid for again.
The JAX map is then resolved (windowed), and the port's map takes its
resolved store too, so that each read method sees the same arrays in both
packages: their outputs are held equal, resolved and unresolved, except
``predict_drt`` (at derivative orders 0-3), whose eval matrices are one rounding apart
(numpy in the port, jnp in the JAX package) and are held within 1e-12 of
the largest |value|. A second port map resolves itself, to show both
branches of ``predict_x(resolved=True)`` on the port's own resolve.
tests/test_mapping.py:84-92, :160-186 and :371-384 are re-run through the
port, and save/load is held both ways across the packages, the port's side
in a process where JAX cannot be imported.
"""
import copy
import pickle
import sys
import warnings
from copy import deepcopy
from pathlib import Path

import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_tpu.models.drt import _hypers_to_pytree
from hybdrt_tpu.solver import qphb as jax_qphb
from hybdrt_torch.mapping.drtmd import DRTMD, STATE_KEYS, load_fit_state
from hybdrt_torch.ops import basis as basis_mod
from hybdrt_torch.utils import probe
from test_torch_drtmd_serial import (_hold_convergence_summary, _hold_default_resolve,
                                     _hold_drt_var_and_probabilities, _hold_param_and_x_cov)
from test_torch_filters import assert_same

import serial_maps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("mixed", "eis", "hybrid")


def _build(kind, cls, **kw):
    tau, obs = probe.small_map(kind)
    md = cls(tau, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
    for psi, c, e in obs:
        md.add_observation(psi, c, e, group_id="g")
    return md


def _maps(kind, **kw):
    return _build(kind, JaxDRTMD, **kw), _build(kind, DRTMD, device="cpu", **kw)


def _state(md, keys=STATE_KEYS):
    """A map's state as numpy arrays and plain values."""
    def plain(v):
        if isinstance(v, dict):
            return {k: plain(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(plain(u) for u in v)
        if v is None or isinstance(v, (bool, int, float, str, np.ndarray)):
            return v
        return np.asarray(v)
    return {k: plain(getattr(md, k)) for k in keys}


@pytest.fixture(scope="module")
def fitted():
    """Each small map fitted batched by both packages; not resolved or
    otherwise changed by any test (the sections below copy it)."""
    out = {}
    for kind in KINDS:
        mj, mt = _maps(kind)
        mj.fit_all(batched=True)
        mt.fit_all(batched=True)
        out[kind] = (mj, mt)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_fit_all_matches_jax(fitted, kind):
    mj, mt = fitted[kind]
    assert mt.obs_fit_status.all() and mj.obs_fit_status.all()
    assert mt.obs_tau_indices == mj.obs_tau_indices
    for i in range(mt.num_obs):
        aj, at = mj.obs_fit_attr[i], mt.obs_fit_attr[i]
        assert (at["n_iter"], at["converged"]) == (aj["n_iter"], aj["converged"]), i
        assert bool(at.get("ragged")) == bool(aj.get("ragged"))
        assert at.get("fitter_key") == aj.get("fitter_key")
        assert np.max(np.abs(mt.obs_x[i] - mj.obs_x[i])) < 1e-6 * np.max(np.abs(mj.obs_x[i]))
    for key in ("R_inf", "inductance"):
        np.testing.assert_allclose(mt.obs_special[key], mj.obs_special[key], rtol=1e-6)
    assert set(mt.obs_special) == set(mj.obs_special)
    np.testing.assert_allclose(mt.obs_rss, mj.obs_rss, rtol=1e-6)
    np.testing.assert_allclose(mt.obs_llh, mj.obs_llh, rtol=1e-6)


@pytest.mark.parametrize("kind,fitter", [("mixed", "BatchedRaggedFitter"),
                                         ("eis", "BatchedEISFitter"),
                                         ("hybrid", "BatchedHybridFitter")])
def test_groups_route_to_the_same_fitter(fitted, kind, fitter):
    mj, mt = fitted[kind]
    kinds_t = {type(f).__name__ for f in mt._fitter_cache.values()}
    kinds_j = {type(f).__name__ for f in mj._fitter_cache.values()}
    assert kinds_t == kinds_j == {fitter}


def test_store_matches_jax(fitted):
    """The observation store as the JAX class keeps it."""
    mj, mt = fitted["mixed"]
    assert mt.num_obs == mj.num_obs == 8
    np.testing.assert_array_equal(mt.obs_psi, mj.obs_psi)
    assert mt.obs_group_id == mj.obs_group_id
    assert mt.unique_group_ids() == mj.unique_group_ids() == ["g"]
    np.testing.assert_array_equal(mt.get_group_index("g"), mj.get_group_index("g"))
    np.testing.assert_array_equal(mt.fitted_obs_index(), mj.fitted_obs_index())
    for i in range(mt.num_obs):
        for a, b in zip(mt.get_obs_data(i), mj.get_obs_data(i)):
            for u, v in zip(a, b):
                assert (u is None and v is None) or np.array_equal(u, v)
    for name in ("obs_x_resolved", "obs_drt_var", "obs_x_filt"):
        assert getattr(mt, name).shape == getattr(mj, name).shape
    assert set(mt.obs_special_resolved) == set(mj.obs_special_resolved)


def test_drt_attributes_round_trip():
    """DRT.get_attributes / set_attributes of the config and fit_core
    categories carry a fit over; a fit without DOP holds fit_dop False and
    nu_epsilon None, as the JAX DRT's does."""
    from hybdrt_torch import DRT
    tau, obs = probe.small_map("eis")
    _, _, (freq, z) = obs[0]
    drt = DRT(tau_supergrid=tau, device="cpu").fit_eis(freq, z)
    att = drt.get_attributes()
    assert set(att) == set(drt.attribute_categories["config"]) \
        | set(drt.attribute_categories["fit_core"])
    assert att["fit_dop"] is False and att["nu_epsilon"] is None
    assert att["fit_kwargs"]["nonneg"] is True and att["series_neg"] is False
    other = DRT(device="cpu").set_attributes(att)
    np.testing.assert_array_equal(other.predict_z(freq), drt.predict_z(freq))
    att["basis_tau"][0] = -1.0  # a deep copy
    assert drt.basis_tau[0] > 0


def test_incremental_fit_all_reuses_fitter():
    """tests/test_mapping.py:487: a second fit_all with observations on a new
    grid reuses the cached ragged fitter and fits as a fresh map does."""
    rng = np.random.default_rng(3)
    grids = [np.logspace(5, -1, 31), np.logspace(4, -2, 25)]
    obs = []
    for k in range(7):
        f = grids[k % 2]
        z = 0.35 + probe._zarc(f, 1.0 + 0.1 * k, 10 ** (-2 + 0.3 * k))
        obs.append((f, z + (rng.normal(size=len(f)) + 1j * rng.normal(size=len(f))) * 1e-3))
    tau = np.logspace(-7, 2, 91)
    md = DRTMD(tau, psi_dim_names=["T"], device="cpu")
    for k in range(4):
        md.add_observation([float(k)], None, obs[k])
    md.fit_all(batched=True)
    fitter1 = next(iter(md._fitter_cache.values()))
    for k in range(4, 7):
        md.add_observation([float(k)], None, obs[k])
    md.fit_all(batched=True)
    assert md.obs_fit_status.all()
    assert len(md._fitter_cache) == 1 and next(iter(md._fitter_cache.values())) is fitter1
    fresh = DRTMD(tau, psi_dim_names=["T"], device="cpu")
    for k in range(7):
        fresh.add_observation([float(k)], None, obs[k])
    fresh.fit_all(batched=True)
    np.testing.assert_allclose(md.obs_x, fresh.obs_x, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(md.obs_llh, fresh.obs_llh, rtol=1e-6, atol=1e-8)


def test_ignore_errors_marks_a_nonfinite_lane_ignored(monkeypatch):
    _, md = _maps("eis")
    from hybdrt_torch.parallel.batch import BatchedEISFitter
    real = BatchedEISFitter.fit

    def poisoned(self, *a, **k):
        res = real(self, *a, **k)
        res.x[1, 3] = np.nan
        return res

    monkeypatch.setattr(BatchedEISFitter, "fit", poisoned)
    with pytest.raises(ValueError, match="non-finite"):
        md.fit_all(batched=True)
    md.fit_all(refit=True, batched=True, ignore_errors=True)
    assert not md.obs_fit_status[1] and md.obs_ignore_flag[1]
    assert isinstance(md.obs_fit_errors[1], ValueError)
    assert md.obs_fit_status[[0, 2, 3, 4, 5]].all()
    with pytest.raises(ValueError, match="not been fitted"):
        md.get_fit(1)


def test_get_fit_of_a_ragged_observation_predicts_z(fitted):
    """tests/test_ragged.py:160."""
    _, mt = fitted["mixed"]
    _, _, (f0, z0) = probe.small_map("mixed")[1][0]
    drt = mt.get_fit(0)
    assert np.median(np.abs(drt.predict_z(f0) - z0) / np.abs(z0)) < 0.05


def _raises(item, fn):
    with pytest.raises(NotImplementedError, match=rf"item {item}(?![\d(])"):
        fn()


UNPORTED = {
    "mesh": ("10", lambda md: md.fit_all(batched=True, mesh=object())),
    "resolve mesh": ("10", lambda md: md.resolve_group("g", batched=True, mesh=object())),
    "fit_type=pfrt": ("9", lambda md: DRTMD(md.tau_supergrid, fit_type="pfrt",
                                            device="cpu")),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_options_raise(fitted, name):
    item, fn = UNPORTED[name]
    _raises(item, lambda: fn(fitted["eis"][1]))


def test_a_file_observation_raises():
    md = DRTMD(np.logspace(-7, 2, 71), device="cpu")
    md.add_observation([0.0], None, "spectrum.csv")
    with pytest.raises(NotImplementedError, match="Host modules"):
        md.get_obs_data(0)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert DRTMD(np.logspace(-7, 2, 71)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DRTMD(np.logspace(-7, 2, 71))


def test_make_het_map_is_the_benchmarks():
    """utils/probe.py::make_het_map holds bench.py::make_het_map's
    observations, and make_het_eis / make_het_hybrid its two halves."""
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
    ref = bench.make_het_map(768, 256)
    md = probe.make_het_map(768, 256, device="cpu")
    assert md.num_obs == ref.num_obs == 1024
    assert md.batch_fit_kw == ref.batch_fit_kw
    np.testing.assert_array_equal(md.obs_psi, ref.obs_psi)
    assert md.obs_group_id == ref.obs_group_id
    eis, _ = probe.make_het_eis()
    hyb, _ = probe.make_het_hybrid()
    halves = {"eis": iter(eis), "hybrid": iter(hyb)}

    def arrays(obs):
        return [a for part in obs if part is not None for a in part]

    for (c, e), ref_obs in zip(md.obs_data, ref.obs_data):
        mine = arrays((c, e))
        assert all(np.array_equal(a, b) for a, b in zip(mine, arrays(ref_obs)))
        half = next(halves["eis" if c is None else "hybrid"])
        assert all(np.array_equal(a, b) for a, b in zip(mine, arrays(half)))
    assert next(halves["eis"], None) is None and next(halves["hybrid"], None) is None


# the modules the JAX-free process below cannot import: JAX, hybdrt_tpu,
# bench.py and the packages the GPU machine lacks
BLOCKED = ("jax", "jaxlib", "hybdrt_tpu", "bench", "sklearn", "pandas", "networkx")


@pytest.fixture(scope="module")
def jax_free(read_maps, tmp_path_factory):
    """The module's two JAX-free checks, each a script run in one process
    where BLOCKED cannot be imported (``serial_maps.jax_free_run``): every
    module and chip script imported, then the resolved JAX map's pickle
    read. {name: (ok, output, traceback)}."""
    mj, _ = read_maps["resolved"]
    tmp = tmp_path_factory.mktemp("jax_free")
    src = tmp / "jax_map.pkl"
    mj.save_attributes(src)
    expect = tmp / "expect.npz"
    np.savez(expect, x=mj.predict_x(), rp=mj.predict_r_p(resolved=False),
             drt=mj.predict_drt(obs_index=[3], tau=TAU_EVAL),
             badness=mj.score_group_fit_badness("g", psi_sort_dims=["T"])[1])
    parts = {
        "imports": (
            "import pkgutil, importlib, runpy\n"
            "import hybdrt_torch\n"
            "for m in pkgutil.walk_packages(hybdrt_torch.__path__, 'hybdrt_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "for script in ('chip_smoke.py', 'torch_fit_walls.py', 'torch_resolve_walls.py'):\n"
            "    runpy.run_path(script, run_name='not_main')\n"
            "print('ok')\n"),
        "jax_map": (
            "import sys\n"
            "import numpy as np\n"
            "from hybdrt_torch.mapping.drtmd import DRTMD\n"
            f"src, e = {str(src)!r}, np.load({str(expect)!r})\n"
            "md = DRTMD.from_source(src, device='cpu')\n"
            "assert md.num_obs == 8 and md.obs_resolve_status.all()\n"
            "assert np.array_equal(md.predict_x(), e['x'])\n"
            "assert np.array_equal(md.predict_r_p(resolved=False), e['rp'])\n"
            "d = md.predict_drt(obs_index=[3], tau=np.logspace(-7, 2, 46))\n"
            "assert np.max(np.abs(d - e['drt'])) <= 1e-12 * np.max(np.abs(e['drt']))\n"
            "assert np.array_equal(md.score_group_fit_badness('g', psi_sort_dims=['T'])[1], "
            "e['badness'])\n"
            "other = DRTMD(md.tau_supergrid, psi_dim_names=['T'], device='cpu')\n"
            "other.load_attributes(src)\n"
            "assert np.array_equal(other.obs_x_resolved, md.obs_x_resolved)\n"
            "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
            "print('ok')\n")}
    return {"src": src, **serial_maps.jax_free_run(parts, tmp, BLOCKED)}


def test_no_module_imports_jax(jax_free):
    """Every module of hybdrt_torch, and the chip scripts, import with JAX,
    hybdrt_tpu, bench.py and the packages the GPU machine lacks (sklearn,
    pandas, networkx) made unimportable; and no line of them imports JAX or
    hybdrt_tpu."""
    ok, stdout, err = jax_free["imports"]
    assert ok and stdout.strip().endswith("ok"), err[-2000:]
    files = [*sorted((ROOT / "hybdrt_torch").rglob("*.py")), ROOT / "chip_smoke.py",
             ROOT / "torch_fit_walls.py", ROOT / "torch_resolve_walls.py"]
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code_part = line.split("#")[0].strip()
            assert not code_part.startswith(("import jax", "from jax", "import hybdrt_tpu",
                                             "from hybdrt_tpu")), f"{path}:{n}: {line}"


# ---------------------------------------------------------------------------
# The batched maps' variance, readouts and default resolve (the serial
# maps' are in tests/test_torch_drtmd_serial.py, whose holds these share)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def batched(fitted):
    """Copies of the batched "eis" and "mixed" maps, which this section's
    readouts change (stored variances, rebuilt fits)."""
    return {kind: copy.deepcopy(fitted[kind]) for kind in ("eis", "mixed")}


def test_fit_convergence_summary(batched):
    for kind in ("mixed", "eis"):
        _hold_convergence_summary(*batched[kind])


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


@pytest.mark.parametrize("which", ["batched-mixed"])
def test_param_and_x_cov(batched, which):
    _hold_param_and_x_cov(*batched[which.split("-")[1]])


@pytest.mark.parametrize("which", ["batched-mixed"])
def test_drt_var_and_probabilities(batched, which):
    _hold_drt_var_and_probabilities(*batched[which.split("-")[1]])


@pytest.mark.parametrize("kind", ["eis-batched"])
def test_default_resolve_matches_jax(batched, kind, monkeypatch):
    """The reference's default resolve, one dense QP a window, of the
    batched "eis" map."""
    _hold_default_resolve(*batched[kind.split("-")[0]], monkeypatch)


# ---------------------------------------------------------------------------
# The (P, q) rebuild and the group resolve
# ---------------------------------------------------------------------------
PQ_RTOL, PQ_ATOL = 1e-9, 1e-11


@pytest.fixture(scope="module")
def maps(fitted):
    """A copy of the fitted maps, which this section's tests resolve in place."""
    return copy.deepcopy(fitted)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=PQ_RTOL, atol=PQ_ATOL)


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
                                           gj[i].fit_parameters[key], rtol=PQ_RTOL, atol=1e-13)


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
        np.testing.assert_allclose(pt[off], pj[off], rtol=PQ_RTOL, atol=PQ_ATOL)
        np.testing.assert_allclose(np.delete(qt, vz), np.delete(qj, vz), rtol=PQ_RTOL, atol=PQ_ATOL)
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
        np.testing.assert_allclose(pt, np.asarray(p_ref), rtol=PQ_RTOL, atol=PQ_ATOL)
        np.testing.assert_allclose(qt, np.asarray(q_ref), rtol=PQ_RTOL, atol=PQ_ATOL)


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


# ---------------------------------------------------------------------------
# The read side: predictions, accessors, filters, QC scores, persistence
# ---------------------------------------------------------------------------
RESOLVED_KEYS = ("obs_x_resolved", "obs_special_resolved", "obs_resolve_status")


@pytest.fixture(scope="module")
def read_maps(fitted):
    """{"unresolved": (JAX map, port map), "resolved": (JAX map, port map)}:
    one JAX fit, its state carried into a JAX map that is never resolved and
    into both port maps; the resolved JAX map's resolve carried into the
    resolved port map."""
    mj = copy.deepcopy(fitted["mixed"][0])
    fit_state = _state(mj, STATE_KEYS + ("obs_special_resolved", "obs_special_filt"))
    mj0 = _build("mixed", JaxDRTMD)
    for k, v in deepcopy(fit_state).items():
        setattr(mj0, k, v)
    port_state = {k: fit_state[k] for k in STATE_KEYS}
    mt = load_fit_state(_build("mixed", DRTMD, device="cpu"), deepcopy(port_state))
    mj.resolve_group("g", psi_sort_dims=["T"], batched=True)
    mt_res = load_fit_state(_build("mixed", DRTMD, device="cpu"), deepcopy(port_state))
    for k, v in deepcopy(_state(mj, RESOLVED_KEYS)).items():
        setattr(mt_res, k, v)
    return {"unresolved": (mj0, mt), "resolved": (mj, mt_res)}


TAU_EVAL = np.logspace(-7, 2, 46)
READS = {
    "predict_x": lambda md, r: (md.predict_x(resolved=r), md.predict_x(obs_index=[0, 3], resolved=r),
                                md.predict_x(psi=[[2.4], [6.6]], resolved=r)),
    "predict_r_p": lambda md, r: (md.predict_r_p(resolved=r),
                                  md.predict_r_p(psi=[[0.2]], resolved=r)),
    "predict_special": lambda md, r: tuple(
        md.predict_special(k, psi=psi, obs_index=idx, resolved=r)
        for k in ("R_inf", "inductance") for psi, idx in ((None, None), (None, [4]),
                                                           ([[5.1]], None))),
    "filter_observations": lambda md, r: (
        md.filter_observations(psi_sort_dims=["T"], resolved=r, store=False),
        md.filter_observations(obs_index=[5, 1, 2], resolved=r, sigma=(1, 2), store=False),
        md.filter_group("g", resolved=r, mode="nearest", store=False)),
    "accessors": lambda md, r: (md.get_tau_eval(), md.get_tau_eval(5), md.get_nu_eval(11),
                                md.tau_basis_area, md.get_psi_index([[1.2], [7.0]]),
                                md.obs_dtype, md.filter_psi(dim_gt={"T": 2.5}),
                                md.filter_psi(dim_lt={"T": 4.0}, return_index=False),
                                md.filter_psi(dim_eq={"T": 3.0}, exclude_flagged=True),
                                md.fitted_obs_index(), md.unique_group_ids()),
    "score_group_fit_badness": lambda md, r: (
        md.score_group_fit_badness("g", psi_sort_dims=["T"]),
        md.score_group_fit_badness("g", median_size=(3, 1), std_size=(3, 3)),
        md.obs_fit_badness.copy()),
    "attribute_categories": lambda md, r: (md.attribute_categories,
                                           sorted(md.get_attributes("config")),
                                           sorted(md.get_attributes(["obs_data", "fit"]))),
}


@pytest.mark.parametrize("resolved", ["unresolved", "resolved"])
@pytest.mark.parametrize("name", sorted(READS))
def test_read_side_matches_jax(read_maps, name, resolved):
    mj, mt = read_maps[resolved]
    out_j = READS[name](mj, resolved == "resolved")
    out_t = READS[name](mt, resolved == "resolved")
    assert_same(out_j, out_t)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_predict_drt_matches_jax(read_maps, order):
    """predict_drt at derivative orders 0-3, resolved and not, and the
    fitted DRT's predict_distribution at the same orders (the port's DRT
    from ``get_fit``, rebuilt from the same fit)."""
    for key in ("unresolved", "resolved"):
        mj, mt = read_maps[key]
        for kw in ({}, {"obs_index": [0, 7], "tau": TAU_EVAL}, {"psi": [[1.4]]}):
            ref = mj.predict_drt(order=order, resolved=key == "resolved", **kw)
            out = mt.predict_drt(order=order, resolved=key == "resolved", **kw)
            assert out.shape == ref.shape
            assert np.max(np.abs(out - ref)) <= 1e-12 * np.max(np.abs(ref))
    dj, dt = read_maps["resolved"][0].get_fit(2), read_maps["unresolved"][1].get_fit(2)
    ref = np.asarray(dj.predict_distribution(tau=TAU_EVAL, order=order))
    out = dt.predict_distribution(tau=TAU_EVAL, order=order)
    assert np.max(np.abs(out - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_obs_psi_df_matches_jax(read_maps):
    pd = pytest.importorskip("pandas")
    mj, mt = read_maps["unresolved"]
    pd.testing.assert_frame_equal(mt.obs_psi_df(), mj.obs_psi_df())
    assert list(mt.obs_psi_df()["T"]) == list(np.arange(8.0))


def test_own_resolve_feeds_predictions(read_maps):
    """Before a resolve, predict_x(resolved=True) reads obs_x; after the
    port's own windowed resolve, obs_x_resolved, within the resolve's
    tolerance of the JAX map's (``test_resolve_matches_jax`` above)."""
    mj_res, _ = read_maps["resolved"]
    mt = load_fit_state(_build("mixed", DRTMD, device="cpu"), deepcopy(_state(mj_res, STATE_KEYS)))
    np.testing.assert_array_equal(mt.predict_x(resolved=True), mt.obs_x)
    np.testing.assert_array_equal(mt.predict_special("R_inf", resolved=True),
                                  mt.obs_special["R_inf"])
    mt.resolve_group("g", psi_sort_dims=["T"], batched=True)
    assert mt.obs_resolve_status.all()
    np.testing.assert_array_equal(mt.predict_x(resolved=True), mt.obs_x_resolved)
    np.testing.assert_array_equal(mt.predict_x(resolved=False), mt.obs_x)
    np.testing.assert_allclose(mt.predict_x(), mj_res.predict_x(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(mt.predict_special("R_inf"), mj_res.predict_special("R_inf"),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(mt.predict_r_p(), mj_res.predict_r_p(), rtol=1e-6, atol=1e-8)


def test_mapping_cases_through_the_port(read_maps):
    """tests/test_mapping.py:84-92, :160-186 and :371-384 on the port's map
    (its own copy: clear_fits empties it)."""
    _, carried = read_maps["unresolved"]
    md = load_fit_state(_build("mixed", DRTMD, device="cpu"), deepcopy(_state(carried, STATE_KEYS)))
    n_tau = len(md.tau_supergrid)
    assert md.predict_x(psi=[[0.5]], resolved=False).shape == (1, n_tau)
    assert md.predict_drt(obs_index=[0, 5], resolved=False).shape == (2, n_tau)
    assert md.fitted_obs_index().tolist() == list(range(8))
    assert md.unique_group_ids() == ["g"]
    assert md.get_psi_index([[0.2]]).tolist() == [0]
    assert md.tau_basis_area > 0
    idx = md.filter_psi(dim_gt={"T": 3.5})
    assert np.all(md.obs_psi[idx, 0] > 3.5)
    mask = md.filter_psi(dim_lt={"T": 3.5}, return_index=False)
    assert mask.dtype == bool and mask.sum() == 4
    assert md.filter_psi(dim_eq={"T": 3.0}).tolist() == [3]
    assert md.obs_dtype == ["eis", "eis", "hybrid", "eis", "eis", "hybrid", "eis", "eis"]
    oi, x_f, sp_f = md.filter_observations(psi_sort_dims=["T"])
    assert x_f.shape == (8, n_tau) and np.any(md.obs_x_filt != 0)
    assert set(sp_f) == {"R_inf", "inductance"}
    np.testing.assert_array_equal(md.obs_special_filt["R_inf"][oi], sp_f["R_inf"])
    _, rss = md.score_group_fit_badness("g", psi_sort_dims=["T"])
    assert rss.shape == (8,) and np.all(np.isfinite(rss))
    md.clear_fits()
    assert not md.obs_fit_status.any() and np.all(md.obs_x == 0)
    assert md.obs_fit_attr == [None] * 8 and np.all(md.obs_special["R_inf"] == 0)
    md.clear_obs()
    assert md.num_obs == 0 and md.obs_x.shape == (0, n_tau) and md.device.type == "cpu"


def _walk_types(v, out):
    if isinstance(v, dict):
        for u in v.values():
            _walk_types(u, out)
    elif isinstance(v, (list, tuple)):
        for u in v:
            _walk_types(u, out)
    else:
        out.add(type(v).__module__.split(".")[0])
    return out


def test_jax_pickle_loads_in_the_port_without_jax(jax_free):
    """A resolved map saved by the JAX package loads in the port (from_source
    and load_attributes) in a process where jax and hybdrt_tpu cannot be
    imported, and reads as the JAX map does: the JAX package's pickle holds
    numpy arrays and plain Python values only."""
    with open(jax_free["src"], "rb") as f:
        assert _walk_types(pickle.load(f), set()) <= {"builtins", "numpy"}
    ok, stdout, err = jax_free["jax_map"]
    assert ok and stdout.strip().endswith("ok"), err[-2000:]


def test_port_pickle_loads_in_jax(read_maps, tmp_path):
    """A map saved by the port loads in the JAX package (from_source and
    load_attributes) and reads as the port's does; the port's pickle holds
    no torch object. Saving a category writes that category only."""
    _, mt = read_maps["resolved"]
    src = tmp_path / "port_map.pkl"
    mt.save_attributes(src)
    with open(src, "rb") as f:
        assert _walk_types(pickle.load(f), set()) <= {"builtins", "numpy"}
    mj = JaxDRTMD.from_source(str(src))
    assert_same(_state(mj, mt._persist_attrs), _state(mt, mt._persist_attrs))
    assert_same(mj.predict_x(), mt.predict_x())
    assert_same(mj.predict_r_p(), mt.predict_r_p())
    other = JaxDRTMD(mt.tau_supergrid, psi_dim_names=["T"], warn=False, print_progress=False)
    other.load_attributes(str(src))
    assert_same(other.predict_special("R_inf"), mt.predict_special("R_inf"))
    cfg = tmp_path / "config.pkl"
    mt.save_attributes("config", cfg)
    with open(cfg, "rb") as f:
        assert sorted(pickle.load(f)) == sorted(mt.attribute_categories["config"])
    back = DRTMD.from_source(str(src), device="cpu")
    assert_same(_state(back, mt._persist_attrs), _state(mt, mt._persist_attrs))


def test_from_source_keeps_the_constructors_raises(read_maps):
    """A map of PFRT fits raises from a file or dict, naming its item; the
    DOP configuration, which the constructor takes, builds its map."""
    _, mt = read_maps["unresolved"]
    att = mt.get_attributes()
    nu = np.linspace(-1, 1, 5)
    md = DRTMD.from_source(dict(att, fixed_basis_nu=nu, fit_dop=True), device="cpu")
    assert md.fit_dop and np.array_equal(md.fixed_basis_nu, nu)
    assert md.drt1d.fit_dop and np.array_equal(md.drt1d.fixed_basis_nu, nu)
    with pytest.raises(NotImplementedError, match=r"item 9(?!\d)"):
        DRTMD.from_source(dict(att, fit_type="pfrt"), device="cpu")
    with pytest.raises(ValueError, match="Invalid attribute category"):
        mt.get_attributes("detail")


READ_UNPORTED = {
    "score_group_data_badness": ("9", lambda md: md.score_group_data_badness("g")),
}


@pytest.mark.parametrize("name", sorted(READ_UNPORTED))
def test_unported_read_methods_raise(read_maps, name):
    item, fn = READ_UNPORTED[name]
    with pytest.raises(NotImplementedError, match=rf"item {item}(?![\d(])"):
        fn(read_maps["unresolved"][1])


def test_load_observations_raises():
    md = DRTMD(np.logspace(-7, 2, 71), device="cpu")
    with pytest.raises(NotImplementedError, match="Host modules"):
        md.load_observations([[0.0]], eis_files=["spectrum.csv"])
