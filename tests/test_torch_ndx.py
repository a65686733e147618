"""Port parity: hybdrt_torch/mapping/ndx.py and nddata.py against
hybdrt_tpu/mapping/ndx.py and nddata.py on the CPU, float64.

tests/test_filters_ndx.py's assembly, filtering and QC cases and the rest of
both modules run through both packages on the same seeded inputs (each with
the JAX test's assertions on each package's outputs), and the outputs are
held equal. ``segment_dimension``, which the JAX package computes with
scikit-learn's ``KernelDensity`` and ``DBSCAN`` and the port in numpy, is
held to the same levels and distance threshold on grids with the
rounding ties the reference's own data have (equal gaps that differ in the
last bit), where scikit-learn is installed.
"""
import numpy as np
import pytest
from scipy import interpolate, ndimage

from hybdrt_torch.mapping import ndx
from test_torch_filters import assert_same, run_both


def case_assemble_ndx_grid(m):
    rng = np.random.default_rng(3)
    temps = np.repeat([700, 750, 800], 4)
    biases = np.tile([0.0, 0.1, 0.2, 0.3], 3)
    psi = np.stack([temps, biases], axis=1)
    x = rng.normal(size=(12, 5))
    dims, arr = m.ndx.assemble_ndx(x, psi, ["T", "V"], tau=np.arange(5), group_by=["T"],
                                   sort_by=["V"])
    assert arr.shape == (3, 4, 5)
    assert np.allclose(arr[0, 0], x[0]) and np.allclose(arr[2, 3], x[11])
    return dims, arr


def case_assemble_ndx_missing_points(m):
    rng = np.random.default_rng(4)
    psi = np.stack([np.array([700, 700, 750]), np.array([0.0, 0.1, 0.0])], axis=1)
    x = rng.normal(size=(3, 4))
    dims, arr = m.ndx.assemble_ndx(x, psi, ["T", "V"], tau=np.arange(4), group_by=["T"],
                                   sort_by=["V"], sort_dim_grids=[np.array([0.0, 0.1])])
    assert arr.shape == (2, 2, 4)
    assert np.isnan(arr[1, 1]).all()
    return dims, arr


def case_assemble_ndx_one_sort_dim(m):
    """The bench's call (``sort_by`` of one dimension, no groups): a column of
    ones, the nearest-neighbour interpolator, and cdist's NaN for grid points
    farther than a threshold from every measured point (given grid)."""
    rng = np.random.default_rng(5)
    i = np.array([0.0, 1, 2, 3, 5, 6, 9, 10, 11])
    x = rng.normal(size=(len(i), 7))
    order = rng.permutation(len(i))
    outs = [m.ndx.assemble_ndx(x[order], i[order, None], ["i"], tau=np.arange(7),
                               sort_by=["i"])]
    outs.append(m.ndx.assemble_ndx(x, i[:, None], ["i"], tau=np.arange(7), sort_by=["i"],
                                   sort_dim_grids=[np.arange(12.0)]))
    outs.append(m.ndx.assemble_ndx(x, i[:, None], ["i"], tau=np.arange(7), sort_by=["i"],
                                   sort_dim_grids=[np.arange(12.0)], impute=True))
    outs.append(m.ndx.assemble_ndx(x, i[:, None], ["i"], tau=np.arange(7), sort_by=["i"],
                                   sort_dim_grids=[np.arange(12.0)],
                                   sort_dim_dist_thresh=[0.4]))
    assert np.isnan(outs[1][1][[4, 7, 8]]).all() and np.isfinite(outs[1][1][[0, 5, 11]]).all()
    assert np.isfinite(outs[2][1]).all()
    np.testing.assert_array_equal(outs[0][1], x)
    return outs


def case_assemble_ndx_two_sort_dims(m):
    rng = np.random.default_rng(6)
    t, v = np.meshgrid([700.0, 725, 750], [0.0, 0.05, 0.1, 0.2], indexing="ij")
    psi = np.stack([t.ravel(), v.ravel()], axis=1)[:-2]
    x = rng.normal(size=(len(psi), 3))
    dims, arr = m.ndx.assemble_ndx(x, psi, ["T", "V"], tau=np.arange(3), sort_by=["T", "V"])
    return dims, arr, m.ndx.assemble_ndx(x, psi, ["T", "V"], tau=np.arange(3),
                                         group_by=["T", "V"])


def case_filter_ndx(m):
    rng = np.random.default_rng(7)
    arr = rng.normal(size=(6, 6, 8)) * 0.1 + np.arange(8)
    arr[2, 3] = np.nan
    out = m.ndx.filter_ndx(arr, num_group_dims=2, sigma=(1, 1, 0), iterative=False)
    assert np.isnan(out[2, 3]).all()
    truth = np.arange(8)[None, :].repeat(36, 0).reshape(6, 6, 8)
    valid = ~np.isnan(arr)
    assert np.nanstd(out[valid] - truth[valid]) < np.nanstd(arr[valid] - truth[valid])
    arr[4, 1, 2] = np.nan
    return (out,
            m.ndx.filter_ndx(arr, 2, sigma=(1, 1, 0.5)),
            m.ndx.filter_ndx(arr, 2, impute=True, sigma=(1, 1, 0)),
            m.ndx.filter_ndx(arr, 2, impute=True, impute_groups=True, sigma=(1, 1, 0)),
            m.ndx.filter_ndx(arr, 2, iterative=False, adaptive=True, max_sigma=(1, 1, 0)),
            m.ndx.filter_ndx(arr, 2, iterative=False, mask_nans=False, sigma=1),
            m.ndx.filter_ndx(arr, 1, by_group=True, iterative=False, sigma=(1, 0)),
            m.ndx.filter_ndx(arr, 2, filter_func=ndimage.uniform_filter, size=3),
            m.ndx.group_nn_count(arr, 2), m.ndx.group_nn_count(arr, 2, axis=1),
            m.ndx.group_isnan(arr, 2), m.ndx.flatten_groups(arr, 1))


def case_resample(m):
    rng = np.random.default_rng(8)
    psi_meas = np.stack([np.linspace(0, 1, 9), np.full(9, 2.0)], axis=1)
    x_meas = rng.normal(size=(9, 4))
    psi = np.stack([np.linspace(0.05, 0.95, 5), np.full(5, 2.0)], axis=1)
    psi2 = rng.uniform(size=(20, 2))
    return (m.ndx.resample(psi, psi_meas, x_meas),
            m.ndx.resample(psi2 * 0.8 + 0.1, psi2, rng.normal(size=(20, 3))),
            m.ndx.resample(psi, psi_meas, x_meas, interp_class=interpolate.NearestNDInterpolator,
                           remove_invariant=False))


def case_flag_outliers_and_bad_obs(m):
    rng = np.random.default_rng(3)
    arr = np.tile(np.sin(np.linspace(0, np.pi, 20)), (10, 1))
    arr = arr + rng.normal(size=arr.shape) * 0.01
    arr[4, 10] += 3.0
    flags = m.nddata.flag_outliers(arr, filter_size=(3, 5), thresh=0.5)
    assert flags[4, 10] and flags.sum() < 5
    x_filt = ndimage.gaussian_filter(arr, (1, 0))
    bad_arr = arr.copy()
    bad_arr[7] += rng.normal(size=20) * 2.0
    bad = m.nddata.flag_bad_obs(bad_arr, x_filt, std_size=(3, 5), thresh=3)
    assert bad[7]
    bad_hi = m.nddata.flag_bad_obs(bad_arr, x_filt, std_size=(3, 5), thresh=8)
    assert bad_hi[7] and bad_hi.sum() <= 2
    arr_nan = bad_arr.copy()
    arr_nan[2] = np.nan
    return (flags, bad, bad_hi,
            m.nddata.flag_outliers(arr_nan, filter_size=(3, 5), thresh=0.5),
            m.nddata.flag_bad_obs(arr_nan, x_filt, std_size=(3, 5), return_rss=True,
                                  test_factor_correction=True, test_offset_correction=True),
            m.nddata.flag_bad_obs([bad_arr, arr], [x_filt, x_filt], std_size=(3, 5),
                                  use_robust_std=False, return_rss=True))


def case_nddata_rest(m):
    rng = np.random.default_rng(9)
    freq = np.logspace(4, 0, 9)
    z = [0.3 + 1 / (1 + 2j * np.pi * freq * 10 ** (-3 + k / 4)) for k in range(6)]
    psi = np.arange(6.0)[:, None]
    dims, ndy = m.nddata.assemble_nddata(z, psi, ["i"], sort_by=["i"])
    ndy_nan = ndy.copy()
    ndy_nan[2, 3:6] = np.nan
    x_raw = rng.normal(size=(6, 10)) + 2.0
    x_filt = ndimage.gaussian_filter(x_raw, 1)
    with pytest.raises(ValueError):
        m.nddata.assemble_nddata([np.ones(3), np.ones(4)], psi[:2], ["i"])
    with pytest.raises(ValueError):
        m.nddata.impute_nans(ndy_nan, method="knn")
    return (dims, ndy, m.nddata.impute_nans(ndy_nan, sigma=1),
            m.nddata.outlier_prob(x_raw, x_filt, 0.1, np.abs(x_raw - x_filt) + 1e-8, 0.01),
            m.nddata.factor_correction(x_raw, x_filt), m.nddata.offset_correction(x_raw, x_filt))


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    out_jax, out_torch = run_both(CASES[name])
    assert_same(out_jax, out_torch)


def _segment_cases():
    """Seeded 1-D psi values: uniform grids (their gaps equal up to the last
    bit), rounded random levels, jittered repeated levels, near-duplicates,
    and gap mixes on both sides of scikit-learn's 11-value brute-force/KD-tree
    switch and its 40-gap leaf."""
    rng = np.random.default_rng(0)
    cases = [np.tile([0.0, 0.1, 0.2, 0.3], 3), np.arange(5) * 0.1, np.arange(12) * 0.1,
             np.array([0.0, 0.2, 0.4, 0.5, 0.6])]
    for n in (3, 5, 8, 11, 12, 20, 60):
        cases.append(np.round(rng.uniform(0, 1, size=n), 1))
        lv = np.sort(rng.uniform(0, 10, max(n // 3, 1)))
        cases.append(np.repeat(lv, 3) + rng.normal(0, 0.01, size=3 * len(lv)))
        cases.append(np.round(np.repeat(np.arange(n) * 0.05 + 700, 2)
                              + rng.choice([0, 1e-9, -1e-9], 2 * n), 8))
    for n in (30, 41, 42, 100):
        cases.append(np.round(np.cumsum(rng.choice([0.1, 0.2, 0.05], size=n)) + 300.0, 8))
    return cases


SEGMENT_CASES = _segment_cases()


@pytest.mark.parametrize("k", range(0, len(SEGMENT_CASES), 6))
def test_segment_dimension_matches_sklearn(k):
    """Each of six cases at min_samples 2, 3 and 4: the same levels and the
    same distance threshold as the JAX function's scikit-learn estimate."""
    pytest.importorskip("sklearn")
    from hybdrt_tpu.mapping import ndx as jax_ndx
    for a in SEGMENT_CASES[k:k + 6]:
        for min_samples in (2, 3, 4):
            ref = jax_ndx.segment_dimension(a, min_samples, return_distance_thresh=True)
            out = ndx.segment_dimension(a, min_samples, return_distance_thresh=True)
            assert_same(ref, out)


def test_segment_dimension_alone():
    """Without scikit-learn's answer: a single value is its own level, and
    three levels measured four times each with jitter come out as three."""
    assert_same(ndx.segment_dimension(np.array([2.0, 2.0]), return_distance_thresh=True),
                (np.array([2.0]), 1.0))
    rng = np.random.default_rng(1)
    a = np.repeat([700.0, 750.0, 800.0], 4) + rng.normal(0, 0.5, 12)
    levels = ndx.segment_dimension(a, min_samples=3)
    assert len(levels) == 3 and np.allclose(levels, [700, 750, 800], atol=1.0)
