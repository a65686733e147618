"""Port parity: the lane-Cholesky kernels of hybdrt_torch/ops/chol_lane.py.

On the CPU each wrapper runs its plain PyTorch version; that version is held
to the JAX Pallas kernels in interpret mode (as tests/test_pallas_lane_kernels
runs them) on the same seeded inputs, float32, rtol = atol = 2e-4. The CUDA
kernels themselves are held to these plain versions on a GPU by
tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hybdrt_tpu.ops.pallas_chol_lane import (
    chol_factor_lane as jax_factor, chol_factor_solve_lane as jax_factor_solve,
    chol_solve_factored_lane as jax_solve_factored, chol_solve_lane as jax_solve)
from hybdrt_torch.ops import chol_lane

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

TOL = 2e-4


def _spd_batch(b, n, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n)).astype(np.float32)
    a = g @ np.swapaxes(g, 1, 2) + n * np.eye(n, dtype=np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    return a, rhs


BATCHES = (4, 130)

# The TPU kernels' outputs in interpret mode by (kernel, n, b). Interpret
# runs cost seconds each, mostly tracing for the shape, and the lanes are
# independent, so the inputs of every batch size of one n go through one call
# per kernel, split by batch afterwards
_JAX = {}


def _jax_outputs(kernel, n, b):
    if (kernel, n, b) not in _JAX:
        cases = [_spd_batch(bb, n, seed=n + bb) for bb in BATCHES]
        a = jnp.asarray(np.concatenate([c[0] for c in cases]))
        rhs = np.concatenate([c[1] for c in cases])
        if kernel == "factor_solve":
            out = jax_factor_solve(a, jnp.asarray(rhs), interpret=True)
        elif kernel == "solve_factored":
            # the JAX factor carries leftover input above the diagonal
            l_j = np.concatenate([_jax_outputs("factor_solve", n, bb)[1] for bb in BATCHES])
            out = (jax_solve_factored(jnp.asarray(l_j), jnp.asarray(rhs * 0.5 - 1.0),
                                      interpret=True),)
        elif kernel == "solve":
            out = (jax_solve(a, jnp.asarray(rhs), interpret=True),)
        else:
            out = (jax_factor(a, interpret=True),)
        out = [np.asarray(o) for o in out]
        start = 0
        for bb in BATCHES:
            _JAX[(kernel, n, bb)] = tuple(o[start:start + bb] for o in out)
            start += bb
    return _JAX[(kernel, n, b)]


@pytest.mark.parametrize("kernel", ["factor_solve", "solve_factored", "solve", "factor"])
@pytest.mark.parametrize("n", [5, 16, 17, 37])
@pytest.mark.parametrize("b", BATCHES)
def test_plain_matches_pallas_interpret(kernel, n, b):
    a, rhs = _spd_batch(b, n, seed=n + b)
    at, rt = torch.from_numpy(a), torch.from_numpy(rhs)
    if kernel == "factor_solve":
        x, l = chol_lane.chol_factor_solve_lane(at, rt)
        x_j, l_j = _jax_outputs("factor_solve", n, b)
        np.testing.assert_allclose(x.numpy(), x_j, rtol=TOL, atol=TOL)
        # contract: only the lower triangle of a factor is valid
        np.testing.assert_allclose(np.tril(l.numpy()), np.tril(l_j), rtol=TOL, atol=TOL)
    elif kernel == "solve_factored":
        _, l_j = _jax_outputs("factor_solve", n, b)
        rhs2 = rhs * 0.5 - 1.0
        x = chol_lane.chol_solve_factored_lane(torch.from_numpy(np.array(l_j)),
                                               torch.from_numpy(rhs2))
        x_j, = _jax_outputs("solve_factored", n, b)
        np.testing.assert_allclose(x.numpy(), x_j, rtol=TOL, atol=TOL)
    elif kernel == "solve":
        x = chol_lane.chol_solve_lane(at, rt)
        x_j, = _jax_outputs("solve", n, b)
        np.testing.assert_allclose(x.numpy(), x_j, rtol=TOL, atol=TOL)
    else:
        l = chol_lane.chol_factor_lane(at)
        l_j, = _jax_outputs("factor", n, b)
        np.testing.assert_allclose(np.tril(l.numpy()), np.tril(l_j), rtol=TOL, atol=TOL)
        # the factor-only wrapper leaves its input as it was
        np.testing.assert_array_equal(at.numpy(), a)


def test_non_positive_pivot_gives_nan():
    a, rhs = _spd_batch(4, 9, seed=1)
    a[1, 4, 4] = -1.0
    a[2] = -a[2]
    x, l = chol_lane.chol_factor_solve_lane(torch.from_numpy(a), torch.from_numpy(rhs))
    x3 = chol_lane.chol_solve_lane(torch.from_numpy(a), torch.from_numpy(rhs))
    x_j = np.asarray(jax_solve(jnp.asarray(a), jnp.asarray(rhs), interpret=True))
    for xs in (x.numpy(), x3.numpy(), x_j):
        assert np.isnan(xs[1]).all() and np.isnan(xs[2]).all()
        assert np.isfinite(xs[0]).all() and np.isfinite(xs[3]).all()
    assert np.isnan(np.diagonal(l.numpy()[1])[4:]).all()
    np.testing.assert_allclose(x.numpy()[[0, 3]], x_j[[0, 3]], rtol=TOL, atol=TOL)


def test_cpu_calls_do_not_count_launches():
    chol_lane.reset_launch_counts()
    a, rhs = _spd_batch(3, 6, seed=2)
    at, rt = torch.from_numpy(a).double(), torch.from_numpy(rhs).double()
    _, l = chol_lane.chol_factor_solve_lane(at, rt)
    chol_lane.chol_solve_factored_lane(l, rt)
    chol_lane.chol_solve_lane(at, rt)
    chol_lane.chol_factor_lane(at)
    assert chol_lane.LAUNCHES == {k: 0 for k in chol_lane.LAUNCHES}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.eye(4).expand(2, 4, 4)
    b = torch.ones(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        chol_lane.check_args("chol_solve_lane", a, b)
    # the lower tiles on at most REG_THREADS_MAX threads: the bench's n = 93
    # and the largest n, 268 and 188, pass the size check (and then need a
    # CUDA tensor); the next n is refused for its tiles, before the device
    for dtype, largest in ((torch.float32, 268), (torch.float64, 188)):
        for n in (93, largest):
            with pytest.raises(ValueError, match="CUDA"):
                chol_lane.check_args("chol_solve_lane", torch.zeros(1, n, n, dtype=dtype),
                                     torch.zeros(1, n, dtype=dtype))
        with pytest.raises(ValueError, match="lower tiles"):
            chol_lane.check_args("chol_solve_lane", torch.zeros(1, largest + 1, largest + 1,
                                                                dtype=dtype),
                                 torch.zeros(1, largest + 1, dtype=dtype))


def _tile_of(t):
    """(I, K) of lower tile t, as csrc/lane_regs.cuh::load_tiles computes it
    (a float32 square root, then exact integer corrections)."""
    i = int((np.sqrt(np.float32(8.0) * np.float32(t) + np.float32(1.0)) - np.float32(1.0))
            * np.float32(0.5))
    while i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_register_geometry_covers_the_lower_triangle(dtype):
    """For every n the kernels admit: the threads' tile slots cover each
    element of the lower triangle exactly once; a block has whole warps, at
    most REG_THREADS_MAX threads and at most MAX_TILES_PER_THREAD tiles a
    thread (so ptxas's cap of 65536 / REG_THREADS_MAX registers a thread
    keeps the block within one SM's registers, the tiles' values taking at
    most 96 of them); its shared memory fits one block."""
    words = torch.finfo(dtype).bits // 32
    ns = [n for n in range(1, 400) if chol_lane.admitted(n, dtype)]
    assert ns == list(range(1, ns[-1] + 1))
    for n in ns:
        threads, tpt, smem = chol_lane.reg_geometry(n, dtype)
        assert threads % 32 == 0 and 32 <= threads <= chol_lane.REG_THREADS_MAX
        assert tpt <= chol_lane.MAX_TILES_PER_THREAD[dtype]
        assert threads * (65536 // chol_lane.REG_THREADS_MAX) <= 65536
        assert tpt * 16 * words <= 96
        assert smem <= chol_lane.MAX_SMEM_BYTES
        nt = -(-n // 4)
        n_tiles = nt * (nt + 1) // 2
        assert (tpt - 1) * threads < n_tiles <= tpt * threads
        count = np.zeros((n, n), dtype=int)
        for s in range(tpt):
            for tid in range(threads):
                t = s * threads + tid
                if t >= n_tiles:
                    continue
                i, k = _tile_of(t)
                assert 0 <= k <= i < nt
                rows = np.arange(4 * i, min(4 * i + 4, n))
                cols = np.arange(4 * k, min(4 * k + 4, n))
                r, c = np.meshgrid(rows, cols, indexing="ij")
                keep = c <= r
                np.add.at(count, (r[keep], c[keep]), 1)
        np.testing.assert_array_equal(count, np.tril(np.ones((n, n), dtype=int)))


def _shared_memory_rule(n, itemsize):
    """The size rule the four kernels admitted n by until chol_solve_factored_lane
    left its (n, n | 1) shared matrix: that matrix and two vectors in one
    block's 232448 bytes of shared memory."""
    return itemsize * (n * (n | 1) + 2 * n) <= 232448


@pytest.mark.parametrize("n", [1, 2, 4, 5, 17, 31, 32, 33, 93, 94, 95, 128, 152, 153, 169, 170,
                               200, 239, 240, 300])
def test_admitted_sizes_are_the_shared_memory_kernels(n):
    """The four kernels take every (n, dtype) that the shared-memory rule took
    (``_shared_memory_rule``), and more: the tile rule alone (``admitted``,
    which check_args applies) takes n up to 268 in float32 and 188 in
    float64; the register geometry holds every tile of those, and
    chol_solve_factored_lane's packed triangle fits one block."""
    for dtype, size, largest in ((torch.float32, 4, 268), (torch.float64, 8, 188)):
        assert chol_lane.admitted(n, dtype) == (n <= largest)
        if _shared_memory_rule(n, size):
            assert chol_lane.admitted(n, dtype)
        if chol_lane.admitted(n, dtype):
            threads, tpt, _ = chol_lane.reg_geometry(n, dtype)
            assert threads * tpt >= (-(-n // 4)) * (-(-n // 4) + 1) // 2
            assert chol_lane.solve_geometry(n, dtype)[1] <= chol_lane.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4), (torch.float64, 8)])
def test_admission_takes_every_n_the_shared_memory_rule_took(dtype, size):
    """Every n from 1 to 400 that the shared-memory rule took is admitted;
    the admitted n are 1 .. largest, and the largest needs every tile a
    thread that the launcher instantiates (MAX_TILES_PER_THREAD on
    REG_THREADS_MAX threads)."""
    ns = [n for n in range(1, 400) if chol_lane.admitted(n, dtype)]
    assert ns == list(range(1, ns[-1] + 1))
    assert all(n in ns for n in range(1, 400) if _shared_memory_rule(n, size))
    assert len(ns) > sum(_shared_memory_rule(n, size) for n in range(1, 400))
    assert chol_lane.reg_geometry(ns[-1], dtype)[:2] == (
        chol_lane.REG_THREADS_MAX, chol_lane.MAX_TILES_PER_THREAD[dtype])


_CHOL_SOURCE = Path(__file__).resolve().parents[1] / "hybdrt_torch" / "csrc" / "chol_lane.cu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [93, 94])
def test_solve_geometry_mirrors_the_source(n, dtype):
    """``chol_lane.solve_geometry`` at the fit's n = 93 and the resolve's 94:
    one warp a block (kSolveThreads in csrc/chol_lane.cu), and the shared
    bytes of ``solve_smem_bytes`` there, the packed lower triangle and w
    (17.8 KB at n = 93 in float32, half the (n, n | 1) matrix it
    replaced)."""
    src = _CHOL_SOURCE.read_text()
    threads = int(re.search(r"constexpr int kSolveThreads = (\d+);", src).group(1))
    assert "sizeof(T) * (static_cast<size_t>(n) * (n + 1) / 2 + n)" in src
    size = torch.finfo(dtype).bits // 8
    assert chol_lane.solve_geometry(n, dtype) == (threads, size * (n * (n + 1) // 2 + n))
    assert threads == chol_lane.SOLVE_THREADS == 32
    if (n, dtype) == (93, torch.float32):
        assert chol_lane.solve_geometry(n, dtype)[1] == 17856
