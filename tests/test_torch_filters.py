"""Port parity: the post-fit pipeline's host helpers, hybdrt_torch/filters
(``_filters``, ``_scifilters``), ``utils/array.py``, ``utils/stats.py`` and
the derivative eval matrices of ``ops/basis.py``, against their
hybdrt_tpu counterparts on the CPU, float64.

Each case runs the same seeded inputs through both packages' functions,
makes the assertions of the JAX package's own test of it
(tests/test_filters_ndx.py, tests/test_mapping_post.py:201) on each
package's outputs, and holds the outputs equal: the copies call the same
numpy/scipy functions in the same order. The eval matrices are built with
jnp in the JAX package and with numpy in the port, so there the two agree
within 1e-13 of the matrix's largest entry, not bit for bit.
``assert_same`` and ``PKGS`` are shared with the other
tests/test_torch_{ndx,surface,drtmd_read}.py files.
"""
from types import SimpleNamespace

import numpy as np
import pytest
from scipy import ndimage

from hybdrt_tpu import filters as jax_filters
from hybdrt_tpu.mapping import extrema as jax_extrema
from hybdrt_tpu.mapping import nddata as jax_nddata
from hybdrt_tpu.mapping import ndx as jax_ndx
from hybdrt_tpu.mapping import surface as jax_surface
from hybdrt_tpu import peaks as jax_peaks
from hybdrt_tpu.ops import basis as jax_basis
from hybdrt_tpu.utils import array as jax_array
from hybdrt_tpu.utils import stats as jax_stats
from hybdrt_torch import filters, peaks
from hybdrt_torch.mapping import extrema, nddata, ndx, surface
from hybdrt_torch.ops import basis
from hybdrt_torch.utils import array, stats

PKGS = {
    "jax": SimpleNamespace(filters=jax_filters, ndx=jax_ndx, nddata=jax_nddata,
                           surface=jax_surface, extrema=jax_extrema, peaks=jax_peaks,
                           array=jax_array, stats=jax_stats),
    "torch": SimpleNamespace(filters=filters, ndx=ndx, nddata=nddata, surface=surface,
                             extrema=extrema, peaks=peaks, array=array, stats=stats),
}


def assert_same(a, b, path="out"):
    """a and b equal: the same structure, arrays of the same shape and dtype
    kind with equal values (NaN where the other has NaN), scalars equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, \
            f"{path}: {a.shape} {a.dtype} against {b.shape} {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=path)


def run_both(case):
    """The case's outputs from the JAX package and from the port, each
    after the case's own assertions."""
    return case(PKGS["jax"]), case(PKGS["torch"])


# ---------------------------------------------------------------------------
# tests/test_filters_ndx.py's filter cases, and the rest of the filters
# ---------------------------------------------------------------------------
def case_rms_std_iqr(m):
    a = np.random.default_rng(3).normal(size=(40, 40))
    r = m.filters.rms_filter(a, 5)
    assert r.shape == a.shape and np.all(r >= 0)
    s = m.filters.std_filter(a, 5)
    assert np.all(s >= 0) and abs(np.median(s) - 1.0) < 0.3
    q = m.filters.iqr_filter(a, 5)
    assert np.all(q >= 0)
    mask = (a > -1.5).astype(float)
    return r, s, q, m.filters.rms_filter(a, 5, empty=True), m.filters.std_filter(a, 5, mask=mask)


def case_empty_gaussian(m):
    a = np.zeros(21)
    a[10] = 1.0
    out = m.filters.empty_gaussian_filter1d(a, sigma=2)
    assert out[10] == 0 and out[9] > 0 and out[11] > 0
    a2 = np.zeros((11, 11))
    a2[5, 5] = 1.0
    out2 = m.filters.empty_gaussian_filter(a2, sigma=1.5)
    assert out2[5, 5] == 0 and out2[5, 6] == 0 and out2[6, 5] == 0
    assert out2[6, 6] > 0 and out2[4, 6] > 0
    b = np.random.default_rng(4).normal(size=(12, 30))
    return (out, out2, m.filters.empty_gaussian_filter(b, (1.0, 2.5), order=(0, 1)),
            m.filters.gaussian_laplace1d(b, 2.0))


def case_masked_filter(m):
    a = np.ones((20, 20))
    a[5, 5] = 100.0
    mask = np.ones_like(a)
    mask[5, 5] = 0
    out = m.filters.masked_filter(a, mask, sigma=2)
    assert np.allclose(out[~np.isnan(out)], 1.0, atol=1e-10)
    b = np.random.default_rng(5).normal(size=(16, 16))
    b_nan = b.copy()
    b_nan[3:5, 7] = np.nan
    return (out, m.filters.masked_filter(b, (b > 0).astype(float), ndimage.uniform_filter,
                                         size=3),
            m.filters.nan_filter(b_nan, ndimage.gaussian_filter, sigma=1.0))


def case_iterative_gaussian(m):
    rng = np.random.default_rng(6)
    x = np.linspace(0, 4 * np.pi, 200)
    clean = np.sin(x)
    noisy = clean + rng.normal(size=200) * 0.02
    noisy[50] += 5.0
    out = m.filters.iterative_gaussian_filter(noisy, sigma=2)
    plain = ndimage.gaussian_filter(noisy, sigma=2)
    assert abs(out[50] - clean[50]) < abs(plain[50] - clean[50]) / 3
    img = rng.normal(size=(20, 30)) * 0.1 + np.linspace(0, 1, 30)
    img[4, 9] += 3.0
    nan_mask = np.zeros(img.shape, dtype=bool)
    nan_mask[10, :5] = True
    return (out,
            m.filters.iterative_gaussian_filter(img, sigma=(1, 2), nan_mask=nan_mask,
                                                fill_nans=True),
            m.filters.iterative_gaussian_filter(img, adaptive=True, iter=3, max_sigma=(1, 2)),
            m.filters.iterate_gaussian_weights(img, sigma=1.5))


def case_nonuniform_gaussian(m):
    rng = np.random.default_rng(7)
    a = rng.normal(size=100)
    sigma = np.linspace(0.1, 5, 100)
    out = m.filters.nonuniform_gaussian_filter1d(a, sigma)
    assert out.shape == a.shape
    assert np.std(np.diff(out[80:])) < np.std(np.diff(out[:20]))
    assert np.allclose(m.filters.nonuniform_gaussian_filter1d(a, np.zeros(100)), a)
    b = rng.normal(size=(15, 40))
    sig2 = [np.full(b.shape, 0.8), np.tile(np.linspace(0.2, 3, 40), (15, 1))]
    return (out, m.filters.nonuniform_gaussian_filter1d(a, sigma, empty=True),
            m.filters.nonuniform_gaussian_filter(b, sig2))


def case_adaptive_gaussian(m):
    rng = np.random.default_rng(8)
    b = np.cumsum(rng.normal(size=(15, 40)), axis=1)
    sig1 = m.filters.get_adaptive_sigma1d(b[0])
    sigmas = m.filters.get_adaptive_sigmas(b, presmooth_sigma=1)
    return (sig1, sigmas, m.filters.adaptive_gaussian_filter1d(b[0]),
            m.filters.adaptive_gaussian_filter(b, sigmas=sigmas),
            m.filters.adaptive_gaussian_filter(b, presmooth_sigma=1, max_sigma=(1, 3)))


def case_rog_and_apply(m):
    rng = np.random.default_rng(9)
    b = rng.normal(size=(24, 24)) + 2.0
    return (m.filters.rog_filter(b, 1.0, 4.0), m.filters.rog_filter(b, 1.0, 4.0, mask=b > 2),
            m.filters.apply_filter(b, ndimage.gaussian_filter, {"sigma": 1.5}),
            m.filters.apply_filter(b))


def case_hysteresis(m):
    a = np.zeros(30)
    a[5:10] = [0.3, 0.6, 1.5, 0.6, 0.3]
    a[20:23] = [0.3, 0.6, 0.3]
    out = m.filters.flexible_hysteresis_threshold(a, 0.2, 1.0)
    assert out[5:10].all() and not out[20:23].any()
    b = a - 2 * a[::-1]
    out_s = m.filters.signed_hysteresis_threshold(b, 0.2, 1.0)
    assert out_s.dtype == bool
    img = np.random.default_rng(10).uniform(size=(20, 20))
    return out, out_s, m.filters.flexible_hysteresis_threshold(img, 0.5, 0.9)


# ---------------------------------------------------------------------------
# tests/test_mapping_post.py:201's array and stats helpers, and the rest
# ---------------------------------------------------------------------------
def case_array_stats_helpers(m):
    ua, us = m.array, m.stats
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(500, 3))
    q = ua.weighted_quantile_2d(vals, [0.025, 0.5, 0.975])
    assert q.shape == (3, 3) and np.allclose(q[1], np.median(vals, axis=0), atol=0.1)
    q2 = ua.weighted_quantile_2d(vals, [0.5], np.ones(500))
    assert np.allclose(q[1], q2[0], atol=1e-9)
    a = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    b = np.array([[3.0, 4.0], [9.9, 9.9], [1.0, 2.0]])
    assert ua.row_match_index(a, b).tolist() == [1, -1, 0]
    arrs = [np.arange(12).reshape(3, 4), np.ones((3, 4))]
    out = ua.apply_along_axis_multi(lambda xs: np.sum(xs[0] * xs[1]), 1, arrs)
    assert np.allclose(out, np.arange(12).reshape(3, 4).sum(axis=1))
    ct = ua.inctrapz(np.ones(5), x=np.arange(5.0))
    assert np.allclose(ct, [0, 1, 2, 3, 4])
    x = np.linspace(0.01, 0.99, 50)
    p = us.pdf_beta(x, 2.0, 3.0)
    assert np.trapezoid(p, x) == pytest.approx(1.0, abs=0.01)
    assert np.allclose(np.log(p), us.log_pdf_beta(x, 2.0, 3.0))
    assert us.pdf_dirichlet(np.array([0.3, 0.7]), np.array([1.0, 1.0])) == pytest.approx(1.0)
    assert us.outer_cdf_chi2(0.0, 1.0, 2) == pytest.approx(1.0)
    assert us.outer_cdf_chi2(1e6, 1.0, 2) == pytest.approx(0.0, abs=1e-12)
    return q, q2, out, ct, p, us.log_pdf_beta(x, 2.0, 3.0)


def case_array_grid_helpers(m):
    ua = m.array
    grid = np.logspace(-3, 2, 26)
    idx = np.array([0, 1, 2, 5, 6, 9])
    return (ua.rel_round(np.pi * grid, 4), ua.is_uniform(np.log(grid)),
            ua.is_log_uniform(grid), ua.is_log_uniform(grid + 1.0),
            ua.nearest_index(grid, 0.07), ua.nearest_index(grid, 0.07, constraint=1),
            ua.nearest_index(grid, 0.07, constraint=-1), ua.is_subset(grid[3:7], grid),
            ua.get_subset_index(grid[3:7], grid), ua.unit_step(np.log(grid)),
            ua.group_values(np.r_[grid, grid * (1 + 1e-13)]), ua.find_contiguous_ranges(idx),
            ua.is_monotonic_ascending(grid), ua.is_monotonic(grid[::-1]),
            ua.apply_unit_step(grid, 1.0, 2.0, 3.0), ua.check_equality(grid, grid.copy()),
            ua.check_equality(None, grid), ua.find_contiguous_centers(idx),
            ua.get_intersection_index(idx, [2, 6, 7]))


def case_stats_helpers(m):
    us = m.stats
    x = np.random.default_rng(11).normal(size=(50, 4))
    return (us.robust_std(x), us.robust_std(x, axis=0), us.bic(-10.0, 3, 40),
            us.bayes_factor(1.0, 3.0), us.pdf_lognormal(np.linspace(0.1, 3, 7), 0.2, 0.5),
            us.std_normal_quantile([0.025, 0.5, 0.975]), us.iqr(x),
            us.norm_bayes_factors([3.0, 1.0, 2.0]), us.norm_bayes_factors([3.0, 1.0], "llh"),
            us.harmonic_mean(2.0, 3.0))


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    out_jax, out_torch = run_both(CASES[name])
    assert_same(out_jax, out_torch)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_eval_matrices_match_jax(order):
    """The order-th derivative eval matrix, the port's numpy against the JAX
    package's jnp on the CPU, on the bench's supergrid (111 points) and on an
    evaluation grid of 10 points a decade, within 1e-13 of its max |entry|;
    the cached host matrix is the built one, read-only."""
    tau = np.logspace(-8, 3, 111)
    eps = 1.0 / np.mean(np.diff(np.log(tau)))
    for eval_tau in (None, np.logspace(-8, 3, 141)):
        eval_grid = None if eval_tau is None else np.log(eval_tau)
        ref = np.asarray(jax_basis.construct_func_eval_matrix(np.log(tau), eval_grid,
                                                              "gaussian", eps, order))
        em = basis.construct_func_eval_matrix(np.log(tau), eval_grid, "gaussian", eps, order)
        host = basis.func_eval_matrix_host(np.log(tau), eval_grid, "gaussian", eps, order)
        assert em.shape == ref.shape == host.shape
        assert np.max(np.abs(em - ref)) <= 1e-13 * np.max(np.abs(ref))
        np.testing.assert_array_equal(host, em)
        assert not host.flags.writeable
        assert basis.func_eval_matrix_host(np.log(tau), eval_grid, "gaussian", eps,
                                           order) is host


def test_eval_matrix_orders_and_bases_out_of_range_raise():
    with pytest.raises(ValueError, match="order 4"):
        basis.construct_func_eval_matrix(np.arange(3.0), order=4)
    with pytest.raises(ValueError, match="order 3 not implemented for basis type Cole-Cole"):
        basis.construct_func_eval_matrix(np.arange(3.0), basis_type="Cole-Cole", order=3)
