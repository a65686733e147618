"""The port's copy of the benchmark's spectra (hybdrt_torch/utils/probe.py::
make_batch) against bench.make_batch, which the port's scripts no longer
import: bitwise equal frequencies and impedances."""
import numpy as np
import pytest

from bench import make_batch as bench_make_batch
from hybdrt_torch.utils.probe import make_batch


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("batch,n_freq", [(64, 71), (5, 13)])
def test_make_batch_is_bench_make_batch(batch, n_freq, seed):
    freq, z = make_batch(batch, n_freq, seed=seed)
    freq_b, z_b = bench_make_batch(batch, n_freq, seed=seed)
    assert z.shape == (batch, n_freq) and z.dtype == z_b.dtype
    np.testing.assert_array_equal(freq, freq_b)
    np.testing.assert_array_equal(z, z_b)
