"""Port parity: the read side of hybdrt_torch/mapping/drtmd.py::DRTMD
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
import pickle
import subprocess
import sys
from copy import deepcopy
from pathlib import Path

import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch.mapping.drtmd import DRTMD, STATE_KEYS, load_fit_state
from hybdrt_torch.utils import probe
from test_torch_filters import assert_same

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RESOLVED_KEYS = ("obs_x_resolved", "obs_special_resolved", "obs_resolve_status")


def _build(cls, **kw):
    tau, obs = probe.small_map("mixed")
    md = cls(tau, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
    for psi, c, e in obs:
        md.add_observation(psi, c, e, group_id="g")
    return md


def _state(md, keys):
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
def maps():
    """{"unresolved": (JAX map, port map), "resolved": (JAX map, port map)}:
    one JAX fit, its state carried into a JAX map that is never resolved and
    into both port maps; the resolved JAX map's resolve carried into the
    resolved port map."""
    mj = _build(JaxDRTMD)
    mj.fit_all(batched=True)
    fit_state = _state(mj, STATE_KEYS + ("obs_special_resolved", "obs_special_filt"))
    mj0 = _build(JaxDRTMD)
    for k, v in deepcopy(fit_state).items():
        setattr(mj0, k, v)
    port_state = {k: fit_state[k] for k in STATE_KEYS}
    mt = load_fit_state(_build(DRTMD, device="cpu"), deepcopy(port_state))
    mj.resolve_group("g", psi_sort_dims=["T"], batched=True)
    mt_res = load_fit_state(_build(DRTMD, device="cpu"), deepcopy(port_state))
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
def test_read_side_matches_jax(maps, name, resolved):
    mj, mt = maps[resolved]
    out_j = READS[name](mj, resolved == "resolved")
    out_t = READS[name](mt, resolved == "resolved")
    assert_same(out_j, out_t)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_predict_drt_matches_jax(maps, order):
    """predict_drt at derivative orders 0-3, resolved and not, and the
    fitted DRT's predict_distribution at the same orders (the port's DRT
    from ``get_fit``, rebuilt from the same fit)."""
    for key in ("unresolved", "resolved"):
        mj, mt = maps[key]
        for kw in ({}, {"obs_index": [0, 7], "tau": TAU_EVAL}, {"psi": [[1.4]]}):
            ref = mj.predict_drt(order=order, resolved=key == "resolved", **kw)
            out = mt.predict_drt(order=order, resolved=key == "resolved", **kw)
            assert out.shape == ref.shape
            assert np.max(np.abs(out - ref)) <= 1e-12 * np.max(np.abs(ref))
    dj, dt = maps["resolved"][0].get_fit(2), maps["unresolved"][1].get_fit(2)
    ref = np.asarray(dj.predict_distribution(tau=TAU_EVAL, order=order))
    out = dt.predict_distribution(tau=TAU_EVAL, order=order)
    assert np.max(np.abs(out - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_obs_psi_df_matches_jax(maps):
    pd = pytest.importorskip("pandas")
    mj, mt = maps["unresolved"]
    pd.testing.assert_frame_equal(mt.obs_psi_df(), mj.obs_psi_df())
    assert list(mt.obs_psi_df()["T"]) == list(np.arange(8.0))


def test_own_resolve_feeds_predictions(maps):
    """Before a resolve, predict_x(resolved=True) reads obs_x; after the
    port's own windowed resolve, obs_x_resolved, within the resolve's
    tolerance of the JAX map's (tests/test_torch_drtmd_resolve.py)."""
    mj_res, _ = maps["resolved"]
    mt = load_fit_state(_build(DRTMD, device="cpu"), deepcopy(_state(mj_res, STATE_KEYS)))
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


def test_mapping_cases_through_the_port(maps):
    """tests/test_mapping.py:84-92, :160-186 and :371-384 on the port's map
    (its own copy: clear_fits empties it)."""
    _, carried = maps["unresolved"]
    md = load_fit_state(_build(DRTMD, device="cpu"), deepcopy(_state(carried, STATE_KEYS)))
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


def test_jax_pickle_loads_in_the_port_without_jax(maps, tmp_path):
    """A resolved map saved by the JAX package loads in the port (from_source
    and load_attributes) in a process where jax and hybdrt_tpu cannot be
    imported, and reads as the JAX map does: the JAX package's pickle holds
    numpy arrays and plain Python values only."""
    mj, _ = maps["resolved"]
    src = tmp_path / "jax_map.pkl"
    mj.save_attributes(src)
    with open(src, "rb") as f:
        assert _walk_types(pickle.load(f), set()) <= {"builtins", "numpy"}
    expect = tmp_path / "expect.npz"
    np.savez(expect, x=mj.predict_x(), rp=mj.predict_r_p(resolved=False),
             drt=mj.predict_drt(obs_index=[3], tau=TAU_EVAL),
             badness=mj.score_group_fit_badness("g", psi_sort_dims=["T"])[1])
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'hybdrt_tpu'):\n"
        "    sys.modules[name] = None\n"
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
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_port_pickle_loads_in_jax(maps, tmp_path):
    """A map saved by the port loads in the JAX package (from_source and
    load_attributes) and reads as the port's does; the port's pickle holds
    no torch object. Saving a category writes that category only."""
    _, mt = maps["resolved"]
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


def test_from_source_keeps_the_constructors_raises(maps):
    """A map of PFRT fits raises from a file or dict, naming its item; the
    DOP configuration, which the constructor takes, builds its map."""
    _, mt = maps["unresolved"]
    att = mt.get_attributes()
    nu = np.linspace(-1, 1, 5)
    md = DRTMD.from_source(dict(att, fixed_basis_nu=nu, fit_dop=True), device="cpu")
    assert md.fit_dop and np.array_equal(md.fixed_basis_nu, nu)
    assert md.drt1d.fit_dop and np.array_equal(md.drt1d.fixed_basis_nu, nu)
    with pytest.raises(NotImplementedError, match=r"item 9(?!\d)"):
        DRTMD.from_source(dict(att, fit_type="pfrt"), device="cpu")
    with pytest.raises(ValueError, match="Invalid attribute category"):
        mt.get_attributes("detail")


UNPORTED = {
    "score_group_data_badness": ("9", lambda md: md.score_group_data_badness("g")),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_read_methods_raise(maps, name):
    item, fn = UNPORTED[name]
    with pytest.raises(NotImplementedError, match=rf"item {item}(?![\d(])"):
        fn(maps["unresolved"][1])


def test_load_observations_raises():
    md = DRTMD(np.logspace(-7, 2, 71), device="cpu")
    with pytest.raises(NotImplementedError, match="Host modules"):
        md.load_observations([[0.0]], eis_files=["spectrum.csv"])
