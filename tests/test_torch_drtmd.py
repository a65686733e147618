"""Port parity: the map class hybdrt_torch/mapping/drtmd.py::DRTMD, its
batched fits and observation store, against hybdrt_tpu/mapping/drtmd.py::DRTMD
on the CPU, float64.

Three small maps (``utils/probe.py::small_map``): a mixed one (EIS on two
grids, hybrid on two chrono protocols: the ragged fitter), a uniform EIS one
(the shared-grid EIS fitter) and a uniform hybrid one (the shared-protocol
hybrid fitter). Each is fitted by both packages with ``fit_all(batched=True)``
and held to the same tau windows, iteration counts and flags, coefficients
within 1e-6 of each observation's max |x|, and R_inf, inductance, rss and llh
within rtol 1e-6. The rebuild and the resolve are in
tests/test_torch_drtmd_resolve.py.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch.mapping.drtmd import DRTMD
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("mixed", "eis", "hybrid")


def _maps(kind, **kw):
    tau, obs = probe.small_map(kind)
    mj = JaxDRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
    mt = DRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, device="cpu", **kw)
    for psi, c, e in obs:
        mj.add_observation(psi, c, e, group_id="g")
        mt.add_observation(psi, c, e, group_id="g")
    return mj, mt


@pytest.fixture(scope="module")
def fitted():
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


def test_no_module_imports_jax():
    """Every module of hybdrt_torch, and the chip scripts, import with JAX,
    hybdrt_tpu, bench.py and the packages the GPU machine lacks (sklearn,
    pandas, networkx) made unimportable; and no line of them imports JAX or
    hybdrt_tpu."""
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "for name in ('jax', 'jaxlib', 'hybdrt_tpu', 'bench', 'sklearn', 'pandas', 'networkx'):\n"
        "    sys.modules[name] = None\n"
        "import hybdrt_torch\n"
        "for m in pkgutil.walk_packages(hybdrt_torch.__path__, 'hybdrt_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for script in ('chip_smoke.py', 'torch_fit_walls.py', 'torch_resolve_walls.py'):\n"
        "    runpy.run_path(script, run_name='not_main')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
    files = [*sorted((ROOT / "hybdrt_torch").rglob("*.py")), ROOT / "chip_smoke.py",
             ROOT / "torch_fit_walls.py", ROOT / "torch_resolve_walls.py"]
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code_part = line.split("#")[0].strip()
            assert not code_part.startswith(("import jax", "from jax", "import hybdrt_tpu",
                                             "from hybdrt_tpu")), f"{path}:{n}: {line}"
