"""The port's copy of the benchmark's spectra (hybdrt_torch/utils/probe.py::
make_batch) against bench.make_batch, which the port's scripts no longer
import: bitwise equal frequencies and impedances. And the operation count
behind the chip scripts' bounds (``chol_ops``, ``ip_steps_bound``)."""
import numpy as np
import pytest

from bench import make_batch as bench_make_batch
from hybdrt_torch.utils.probe import chol_ops, ip_steps_bound, make_batch


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("batch,n_freq", [(64, 71), (5, 13)])
def test_make_batch_is_bench_make_batch(batch, n_freq, seed):
    freq, z = make_batch(batch, n_freq, seed=seed)
    freq_b, z_b = bench_make_batch(batch, n_freq, seed=seed)
    assert z.shape == (batch, n_freq) and z.dtype == z_b.dtype
    np.testing.assert_array_equal(freq, freq_b)
    np.testing.assert_array_equal(z, z_b)


def _factor_multiply_adds(n):
    """The lower Cholesky's multiply-adds, counted as the lane kernels apply
    them: column j updates every element (r, c) with j < c <= r < n."""
    count = 0
    for j in range(n):
        for r in range(j + 1, n):
            for c in range(j + 1, r + 1):
                count += 1
    return count


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 17, 93])
def test_chol_ops_counts_the_factors_multiply_adds(n):
    """Two operations per multiply-add of the factor's trailing updates,
    (n^3 - n) / 6 of them: 134044 at n = 93, half the n^3 / 3 once counted."""
    assert chol_ops(3, n) == 3 * 2 * _factor_multiply_adds(n)
    if n == 93:
        assert _factor_multiply_adds(n) == 134044


def test_ip_steps_bounds_at_the_timed_shapes():
    """The fused steps' bounds at (8192, 93, 4) and (1024, 95, 8), float32:
    operations, 0.1565 and 0.0416 ms."""
    for (b, n, t), want in (((8192, 93, 4), 0.1565), ((1024, 95, 8), 0.0416)):
        bound_ms, bound_by = ip_steps_bound(b, n, t)
        assert bound_by == "operations" and round(bound_ms, 4) == want
