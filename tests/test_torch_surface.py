"""Port parity: hybdrt_torch/mapping/surface.py, extrema.py and peaks.py, and
the post-fit map pipeline ``utils/probe.py::run_postproc_pipeline``,
against hybdrt_tpu on the CPU, float64.

tests/test_mapping_post.py's surface and extrema cases (:21, :28, :98, :110,
:137, :300, :310, :407, :428, and the ``ridge_prob`` half of :259) run
through both packages on the same inputs, each with the JAX test's
assertions on each package's outputs, and the outputs are held equal.

The pipeline runs on a seeded 128-row map of two relaxations, one fixed and
one moving across the map, with noise, rows of NaN (failed fits) and the
observations out of psi order. The port's pipeline is ``bench.py``'s five
calls on the port's modules; the JAX side makes the same five calls on the
JAX package's. The eval matrices behind ``coef_to_ridges`` come from numpy
in the port and from jnp in the JAX package, one rounding apart, so the
floats there are held within 1e-12 of each array's largest |value|; the
masks and the bad observations are held equal.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from hybdrt_torch.utils import probe
from test_torch_filters import PKGS, assert_same, run_both

ROOT = Path(__file__).resolve().parents[1]


def _moving_peak_image(n_rows=20, n_cols=60, start=15, slope=1.0, width=3.0):
    img = np.zeros((n_rows, n_cols))
    cols = np.arange(n_cols)
    centers = start + slope * np.arange(n_rows)
    for i, c in enumerate(centers):
        img[i] = np.exp(-0.5 * ((cols - c) / width) ** 2)
    return img, centers


def case_find_ridges_2d_tracks_moving_peak(m):
    img, centers = _moving_peak_image()
    mask = m.surface.find_ridges_2d(img, height=0.5)
    assert np.max(np.abs(np.argmax(mask, axis=1) - centers)) <= 1
    return mask, m.surface.find_ridges(img[None], 1, height=0.5)


def case_troughs_between_ridges(m):
    img1, c1 = _moving_peak_image(start=10, slope=0.5)
    img2, c2 = _moving_peak_image(start=40, slope=-0.5)
    img = img1 + img2
    mask = m.surface.find_ridges_2d(img, height=0.3)
    troughs = m.surface.find_troughs_2d(mask, img, 1 - img)
    for i in range(img.shape[0]):
        t = np.where(troughs[i])[0]
        lo, hi = sorted([c1[i], c2[i]])
        assert len(t) == 1 and lo < t[0] < hi
    return mask, troughs, m.surface.ridge_repulsion(mask, 1 - img, 3)


def case_optimize_extrema_enforces_alternation(m):
    ridge = np.zeros((1, 20), dtype=bool)
    trough = np.zeros((1, 20), dtype=bool)
    ridge[0, [3, 10]] = True
    trough[0, [16]] = True
    r2, t2 = m.extrema.optimize_extrema(ridge, trough)
    assert m.extrema.alternation_energy(r2, t2) == 0
    assert t2[0, 4:10].any() or r2[0].sum() < 2
    return r2, t2


def case_optimize_extrema_keeps_probable_ridge(m):
    ridge = np.zeros((1, 20), dtype=bool)
    trough = np.zeros((1, 20), dtype=bool)
    ridge[0, [3, 10]] = True
    trough[0, [16]] = True
    rp = np.full(ridge.shape, 0.01)
    rp[0, [3, 10]] = 0.999
    tp = np.full(trough.shape, 0.5)
    tp[0, 16] = 0.999
    tp[0, 6] = 0.9
    r2, t2 = m.extrema.optimize_extrema(ridge, trough, rp, tp, lp_scale=60.0)
    assert m.extrema.alternation_energy(r2, t2) == 0
    assert r2[0, 3] and r2[0, 10] and t2[0, 6]
    return r2, t2, m.extrema.count_extrema(r2, t2), m.extrema.count_extrema(t2, r2, False)


def case_surface_find_troughs_and_integrate_ridges(m):
    sf = m.surface
    tau = np.logspace(-4, 0, 60)
    x_grid = np.log(tau)
    n_rows = 6
    f = np.stack([np.exp(-0.5 * ((x_grid + 3.2 + 0.05 * i) / 0.3) ** 2)
                  + 0.6 * np.exp(-0.5 * ((x_grid + 1.0 - 0.05 * i) / 0.3) ** 2)
                  for i in range(n_rows)])
    ridge_mask = np.zeros_like(f, dtype=bool)
    for i in range(n_rows):
        for mu in (-3.2 - 0.05 * i, -1.0 + 0.05 * i):
            ridge_mask[i, np.argmin(np.abs(x_grid - mu))] = True
    p_trough = 1 - f / f.max()
    troughs = sf.find_troughs(ridge_mask, f, p_trough)
    assert troughs.shape == f.shape and np.all(troughs.sum(axis=1) == 1)
    for i in range(n_rows):
        r = np.where(ridge_mask[i])[0]
        assert r[0] < np.where(troughs[i])[0][0] < r[1]
    area = sf.integrate_ridges(f, ridge_mask, troughs, tau=tau)
    assert area.shape == f.shape and np.all((area > 0) == ridge_mask)
    area_g = sf.integrate_ridges(f[None], ridge_mask[None], troughs[None], num_group_dims=1,
                                 tau=tau)
    assert np.allclose(area_g[0], area)
    fxx = np.gradient(np.gradient(f[0]))
    return (troughs, area, area_g, sf.find_troughs(ridge_mask[None], f[None], p_trough[None], 1),
            sf.integrate_ridges(f, ridge_mask, troughs, epsilon_uniform=1.0),
            m.peaks.estimate_peak_weight_distributions(tau, f[0], fxx,
                                                       np.flatnonzero(ridge_mask[0]), tau),
            m.peaks.find_troughs(f[0], fxx, np.flatnonzero(ridge_mask[0])))


def case_ridge_prob_pipeline(m):
    """The ridge_prob half of tests/test_mapping_post.py:259 (its
    smooth_paths half waits with mapping/path.py)."""
    x_grid = np.linspace(-3, 3, 80)
    f = np.stack([np.exp(-0.5 * ((x_grid - 0.5 * np.sin(k / 3)) / 0.4) ** 2) for k in range(12)])
    fx = np.gradient(f, axis=1)
    fxx = np.gradient(fx, axis=1)
    rp = m.surface.ridge_prob(f, fx, fxx, num_group_dims=0)
    assert rp.shape == f.shape and np.max(rp) > 0.5
    truth = np.array([np.argmin(np.abs(x_grid - 0.5 * np.sin(k / 3))) for k in range(12)])
    assert np.all(np.abs(np.argmax(rp, axis=1) - truth) <= 3)
    return (rp, m.surface.ridge_prob(f, fx, fxx, 0, ridge_filter=True, subtract_troughs=False),
            m.surface.ridge_prob_filter(rp, 0),
            m.surface.peak_prob(f, fx, fxx, constrain_sign=True),
            m.surface.peak_prob(f, fx, fxx, f_var=f * 0 + 1e-2, fx_var=f * 0 + 1e-3,
                                fxx_var=f * 0 + 1e-3),
            m.surface.trough_prob(f, fx, fxx))


def case_zero_peaks_weight_decomposition_empty(m):
    tau = np.logspace(-4, 0, 50)
    w = m.peaks.estimate_peak_weight_distributions(tau, np.zeros(50), np.zeros(50),
                                                   np.array([], dtype=int), tau)
    assert w.shape == (0, 50)
    return w, m.surface.integrate_ridges_1d(np.ones(50), np.zeros(50, bool), np.zeros(50, bool))


def case_find_troughs_sign_change_at_zero_crossing(m):
    x_grid = np.linspace(-3, 3, 61)
    f = (np.exp(-0.5 * ((x_grid + 1.5) / 0.4) ** 2)
         - np.exp(-0.5 * ((x_grid - 1.5) / 0.4) ** 2))
    ridge_mask = np.zeros(61, dtype=bool)
    ridge_mask[np.argmin(np.abs(x_grid + 1.5))] = True
    ridge_mask[np.argmin(np.abs(x_grid - 1.5))] = True
    p_trough = np.exp(-0.5 * ((x_grid + 1.0) / 0.2) ** 2)
    troughs = m.surface.find_troughs_1d(ridge_mask, f, p_trough)
    t_idx = np.where(troughs)[0]
    assert len(t_idx) == 1 and abs(x_grid[t_idx[0]]) < 0.2
    return troughs


def case_optimize_extrema_cross_slab_attraction(m):
    ridge = np.zeros((3, 1, 32), dtype=bool)
    trough = np.zeros_like(ridge)
    trough[:, 0, [5, 20]] = True
    ridge[0, 0, 12] = True
    ridge[2, 0, 12] = True
    r2, t2 = m.extrema.optimize_extrema(ridge, trough)
    assert r2.shape == ridge.shape and r2[0, 0, 12] and r2[2, 0, 12] and r2[1, 0, 12]
    for g in range(3):
        assert m.extrema.alternation_energy(r2[g], t2[g]) == 0
    return r2, t2


def case_optimize_extrema_nd_group_dims(m):
    ridge = np.zeros((2, 3, 1, 20), dtype=bool)
    trough = np.zeros_like(ridge)
    ridge[..., 0, [3, 10]] = True
    trough[..., 0, 16] = True
    r2, t2 = m.extrema.optimize_extrema(ridge, trough)
    assert r2.shape == ridge.shape
    for idx in np.ndindex(2, 3):
        assert m.extrema.alternation_energy(r2[idx], t2[idx]) == 0
    rp = np.random.default_rng(12).uniform(size=ridge.shape)
    rp[1, 2] = np.nan
    return r2, t2, m.extrema.optimize_extrema(ridge, trough, rp, 1 - rp, num_loops=2)


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    out_jax, out_torch = run_both(CASES[name])
    assert_same(out_jax, out_torch)


# ---------------------------------------------------------------------------
# The post-fit map pipeline
# ---------------------------------------------------------------------------
TAU = np.logspace(-8, 3, 111)
NAN_ROWS = (17, 18, 90)


def two_peak_map(n=128, seed=21):
    """A fitted map's stand-in (``md``, as the pipeline reads it): coefficients
    on the 111-point supergrid of two relaxations, tau_2 = 1e-4 s fixed and
    tau_1 moving from 10^-2.8 to 10^-1.6 s across psi "i" (the het map's),
    with 5 % noise, a spurious peak at 10 s on row 64, rows of NaN (failed
    fits), and the rows shuffled; ``tau_epsilon`` the supergrid's (10 points
    a decade)."""
    rng = np.random.default_rng(seed)
    ln_tau = np.log(TAU)
    p = np.arange(n) / (n - 1)
    x = (0.8 * np.exp(-0.5 * ((ln_tau[None, :] - np.log(1e-4)) / 0.5) ** 2)
         + (0.5 + 0.4 * p[:, None])
         * np.exp(-0.5 * ((ln_tau[None, :] - np.log(10.0) * (-2.8 + 1.2 * p[:, None])) / 0.6)
                  ** 2))
    x = x * (1 + 0.05 * rng.normal(size=x.shape))
    x[64] += np.exp(-0.5 * ((ln_tau - np.log(10.0)) / 0.6) ** 2)
    x[list(NAN_ROWS)] = np.nan
    order = rng.permutation(n)
    return SimpleNamespace(obs_x=x[order], obs_psi=np.arange(n, dtype=float)[order, None],
                           psi_dim_names=["i"], tau_supergrid=TAU, tau_basis_type="gaussian",
                           tau_epsilon=1 / np.log(10 ** 0.1))


def jax_pipeline(md):
    """bench.py::run_postproc_pipeline's five calls on the JAX package's
    modules, with their outputs."""
    m = PKGS["jax"]
    out = {}
    _, out["x_nd"] = m.ndx.assemble_ndx(md.obs_x, md.obs_psi, md.psi_dim_names,
                                        md.tau_supergrid, sort_by=["i"])
    out["x_filt"] = m.ndx.filter_ndx(out["x_nd"], 0, sigma=(2, 1))
    out["bad"] = m.nddata.flag_bad_obs(out["x_nd"], out["x_filt"])
    out["ridge_mask"], out["trough_mask"], out["p_ridge"], out["p_trough"] = \
        m.surface.coef_to_ridges(out["x_filt"], md, num_group_dims=0)
    out["ridge_opt"], out["trough_opt"] = m.extrema.optimize_extrema(
        out["ridge_mask"], out["trough_mask"], out["p_ridge"], out["p_trough"])
    return out


@pytest.fixture(scope="module")
def pipelines():
    md = two_peak_map()
    timings, out = probe.run_postproc_pipeline(md, return_outputs=True)
    return md, timings, out, jax_pipeline(md)


def test_pipeline_matches_jax(pipelines):
    md, timings, out, ref = pipelines
    assert set(out) == set(ref)
    for key in ("x_nd", "x_filt", "bad"):
        assert_same(ref[key], out[key], key)
    for key in ("ridge_mask", "trough_mask", "ridge_opt", "trough_opt"):
        assert out[key].dtype == bool and out[key].shape == out["x_nd"].shape
        assert_same(ref[key], out[key], key)
    for key in ("p_ridge", "p_trough"):
        scale = np.max(np.abs(ref[key]))
        assert np.max(np.abs(out[key] - ref[key])) <= 1e-12 * scale, key
    assert timings["bad_obs"] == int(ref["bad"].sum())


def test_pipeline_reads_the_map(pipelines):
    """The map's truth, as chip_smoke.py phase 15 reads the het map's:
    NaN exactly on the failed rows, the row with the spurious peak the only
    bad observation, ridges within two supergrid points of both relaxations
    on every row but the failed ones, alternating with the troughs."""
    md, timings, out, _ = pipelines
    assert out["x_nd"].shape == (128, len(TAU))
    assert np.flatnonzero(np.isnan(out["x_nd"]).all(axis=1)).tolist() == list(NAN_ROWS)
    assert np.flatnonzero(out["bad"]).tolist() == [64] and timings["bad_obs"] == 1
    assert probe.max_troughs_between_ridges(out["ridge_opt"], out["trough_opt"]) <= 1
    hybrid = np.zeros(128, dtype=bool)
    hybrid[::4] = True
    het = SimpleNamespace(obs_psi=md.obs_psi, num_obs=128, tau_supergrid=TAU,
                          obs_data=[((), None) if hybrid[int(i)] else (None, ())
                                    for i in md.obs_psi[:, 0]])
    shares = probe.het_truth_shares(het, out["ridge_opt"])
    near = 1 - np.isin(np.arange(128), NAN_ROWS)
    assert shares["eis"]["both"] == near[~hybrid].mean() and \
        shares["hybrid"]["both"] == near[hybrid].mean(), shares
    assert shares["eis"]["rows"] == 96 and shares["hybrid"]["rows"] == 32


def test_pipeline_matches_the_bench_and_its_keys(pipelines):
    """bench.py::run_postproc_pipeline on the same map: the same keys, the
    same bad-observation count, and the port's stages summing to its total."""
    md, timings, out, _ = pipelines
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
    ref = bench.run_postproc_pipeline(md)
    assert set(timings) == set(ref)
    assert timings["bad_obs"] == ref["bad_obs"]
    assert timings["total_s"] == pytest.approx(sum(timings[k] for k in probe.POSTPROC_STAGES))
    assert len(probe.postproc_digest(out)) == 64
    other = dict(out, bad=out["bad"].copy())
    other["bad"][0] = ~other["bad"][0]
    assert probe.postproc_digest(other) != probe.postproc_digest(out)
