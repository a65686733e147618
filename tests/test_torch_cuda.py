"""GPU tests of the port: the CUDA kernels against their plain versions (the
kernels of hybdrt_torch/experiments/ too), the batched fit
(plain and fused warm QPs, cold and warm from a previous frame, the stream
of batches, the history and the parameter covariance), the single DRT (EIS,
chrono and hybrid fits), the batched hybrid fit, the ragged fit (EIS and
hybrid rows) and the group resolve (coupled and windowed) on the card
against the same computations on the CPU.

Every test here is marked ``cuda`` and skips where no CUDA device is present.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from hybdrt_torch import (DRT, BatchedEISFitter, BatchedHybridFitter, BatchedRaggedFitter,
                          resolve_group)
from hybdrt_torch.csrc import build as _build
from hybdrt_torch.experiments import (chol_blocked, chol_column, chol_lane_blocked, ip_loop,
                                      layouts, smem_sol)
from hybdrt_torch.ops import chol_lane, ip_lane
from hybdrt_torch.utils.probe import (GOLDEN_HYPERS, TAU_SUPER, FitLaunches, cov_readouts,
                                      freeze_lane, golden_fit, hybrid_data, inverse_residual,
                                      make_batch, make_frames, make_het_eis, make_het_hybrid,
                                      make_hybrid_batch, qp_batch, readout_errors, spd_batch)

pytestmark = pytest.mark.cuda
TOL = 2e-4  # float32 kernel vs plain, as tests/test_pallas_lane_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.float64, 1e-10)])
@pytest.mark.parametrize("b,n", [(4, 5), (130, 17), (130, 37), (257, 93), (3, 160)])
def test_kernels_match_plain(cuda, b, n, dtype, tol):
    assert chol_lane.admitted(n, dtype)
    a, rhs = spd_batch(b, n, dtype, n + b, cuda)
    chol_lane.reset_launch_counts()
    x, l = chol_lane.chol_factor_solve_lane(a, rhs)
    x_p, l_p = chol_lane.chol_factor_solve_lane_plain(a, rhs)
    torch.testing.assert_close(x, x_p, rtol=tol, atol=tol)
    torch.testing.assert_close(torch.tril(l), l_p, rtol=tol, atol=tol)
    # the factor's upper triangle keeps the input; the solve must ignore it
    torch.testing.assert_close(torch.triu(l, 1), torch.triu(a, 1))
    torch.testing.assert_close(chol_lane.chol_solve_factored_lane(l, rhs), x_p,
                               rtol=tol, atol=tol)
    x3 = chol_lane.chol_solve_lane(a, rhs)
    torch.testing.assert_close(x3, x_p, rtol=tol, atol=tol)
    assert torch.equal(x3, x), "chol_solve_lane's x must be chol_factor_solve_lane's bitwise"
    a_before = a.clone()
    l2 = chol_lane.chol_factor_lane(a)
    torch.testing.assert_close(torch.tril(l2), l_p, rtol=tol, atol=tol)
    torch.testing.assert_close(torch.triu(l2, 1), torch.triu(a, 1))
    torch.cuda.synchronize()
    assert torch.equal(a, a_before), "chol_factor_lane must not write its input"
    assert chol_lane.LAUNCHES == {k: 1 for k in chol_lane.LAUNCHES}


def test_non_positive_pivot_gives_nan(cuda):
    a, rhs = spd_batch(4, 17, torch.float32, 7, cuda)
    a[1, 5, 5] = -1.0
    a[2] = -a[2]
    x, l = chol_lane.chol_factor_solve_lane(a, rhs)
    for xs in (x, chol_lane.chol_solve_lane(a, rhs)):
        assert torch.isnan(xs[1]).all() and torch.isnan(xs[2]).all()
        assert torch.isfinite(xs[0]).all() and torch.isfinite(xs[3]).all()
    for lf in (l, chol_lane.chol_factor_lane(a)):
        assert torch.isnan(torch.diagonal(lf[1])[5:]).all()
        assert torch.isfinite(torch.diagonal(lf[1])[:5]).all()
        assert torch.isnan(torch.diagonal(lf[2])).all()
        assert torch.isfinite(torch.tril(lf[0])).all() and torch.isfinite(torch.tril(lf[3])).all()


def _largest_admitted(dtype):
    return max(n for n in range(1, 400) if chol_lane.admitted(n, dtype))


@pytest.mark.parametrize("b", [1, 133])
@pytest.mark.parametrize("n", [1, 2, 4, 7, 8, 9, 17, 31, 32, 33, 93, 94, 128, "max"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.float64, 1e-10)])
def test_register_factor_kernels(cuda, dtype, tol, n, b):
    """The register-tiled kernels against their plain versions at every tile
    remainder, a panel edge on either side of 32 and 93/94, and the largest n
    either dtype admits; x of chol_solve_lane bitwise that of
    chol_factor_solve_lane (the same factor without its output), the two
    factors bitwise equal on the lower triangle, the upper triangle the
    input's, and the input of the kernels unchanged."""
    n = _largest_admitted(dtype) if n == "max" else n
    a, rhs = spd_batch(b, n, dtype, 7 * n + b, cuda)
    a_in = a.clone()
    chol_lane.reset_launch_counts()
    x, l = chol_lane.chol_factor_solve_lane(a, rhs)
    l4 = chol_lane.chol_factor_lane(a)
    x3 = chol_lane.chol_solve_lane(a, rhs)
    x_p, l_p = chol_lane.chol_factor_solve_lane_plain(a, rhs)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, x_p, rtol=tol, atol=tol)
    torch.testing.assert_close(torch.tril(l), l_p, rtol=tol, atol=tol)
    assert torch.equal(x, x3), "chol_factor_solve_lane's x must be chol_solve_lane's bitwise"
    assert torch.equal(torch.tril(l4), torch.tril(l))
    for lf in (l, l4):
        assert torch.equal(torch.triu(lf, 1), torch.triu(a, 1))
    assert torch.equal(a, a_in), "the kernels must not write their input"
    assert chol_lane.LAUNCHES == {"chol_factor_solve_lane": 1, "chol_solve_factored_lane": 0,
                                  "chol_solve_lane": 1, "chol_factor_lane": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_register_factor_nan_contract(cuda, dtype):
    """A non-positive pivot in the first column, in the first column of a
    panel (8) and in the last column gives NaN from that column on in the
    factor of its lane and in its x, as chol_solve_lane; its neighbours stay
    finite."""
    n = 17
    a, rhs = spd_batch(5, n, dtype, 5, cuda)
    bad = {1: 0, 2: 8, 3: n - 1}
    for lane, col in bad.items():
        a[lane, col, col] = -1.0
    x, l = chol_lane.chol_factor_solve_lane(a, rhs)
    l4 = chol_lane.chol_factor_lane(a)
    x3 = chol_lane.chol_solve_lane(a, rhs)
    assert torch.equal(x.isnan(), x3.isnan())
    assert torch.equal(torch.tril(l4).isnan(), torch.tril(l).isnan())
    for lane, col in bad.items():
        assert torch.isnan(x[lane]).all()
        d = torch.diagonal(l[lane])
        assert torch.isnan(d[col:]).all() and torch.isfinite(d[:col]).all()
    for lane in (0, 4):
        assert torch.isfinite(x[lane]).all() and torch.isfinite(torch.tril(l[lane])).all()


@pytest.mark.parametrize("b", [1, 133])
@pytest.mark.parametrize("n", [1, 4, 5, 17, 33, 93, 94, 95, 128, "max"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.float64, 1e-10)])
def test_solve_factored_kernel(cuda, dtype, tol, n, b):
    """chol_solve_factored_lane (one warp, the packed lower triangle in shared
    memory) against its plain version on either side of a warp's 32 rows,
    at 93/94/95, 128 and the largest n either dtype admits: against
    chol_factor_solve_lane's factor (its upper triangle the input's) it
    gives that kernel's x bitwise, the same substitution orders; its inputs
    are not written, and each call launches once."""
    n = _largest_admitted(dtype) if n == "max" else n
    a, rhs = spd_batch(b, n, dtype, 11 * n + b, cuda)
    x1, l = chol_lane.chol_factor_solve_lane(a, rhs)
    l_in, rhs2 = l.clone(), rhs * 0.5 - 1.0
    chol_lane.reset_launch_counts()
    x = chol_lane.chol_solve_factored_lane(l, rhs2)
    x_own = chol_lane.chol_solve_factored_lane(l, rhs)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, chol_lane.chol_solve_factored_lane_plain(l, rhs2),
                               rtol=tol, atol=tol)
    assert torch.equal(x_own, x1), "x against #1's factor must be #1's x bitwise"
    assert torch.equal(l, l_in)
    assert chol_lane.LAUNCHES["chol_solve_factored_lane"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_factored_nan_contract(cuda, dtype):
    """A factor that is NaN from a failed pivot on (in the first column, the
    first of a panel and the last) gives NaN x in its lane only, where
    chol_factor_solve_lane's x is NaN."""
    n = 17
    a, rhs = spd_batch(5, n, dtype, 5, cuda)
    bad = {1: 0, 2: 8, 3: n - 1}
    for lane, col in bad.items():
        a[lane, col, col] = -1.0
    x1, l = chol_lane.chol_factor_solve_lane(a, rhs)
    x = chol_lane.chol_solve_factored_lane(l, rhs * 0.5 - 1.0)
    assert torch.equal(x.isnan(), x1.isnan())
    for lane in bad:
        assert torch.isnan(x[lane]).all()
    for lane in (0, 4):
        assert torch.isfinite(x[lane]).all()


def test_empty_batch_and_bad_inputs(cuda):
    a, rhs = spd_batch(0, 8, torch.float32, 0, cuda)
    assert chol_lane.chol_solve_lane(a, rhs).shape == (0, 8)
    a, rhs = spd_batch(2, 8, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        chol_lane.chol_solve_lane(a.mT, rhs)
    with pytest.raises(TypeError):
        chol_lane.chol_solve_lane(a.half(), rhs.half())
    with pytest.raises(ValueError):
        chol_lane.chol_solve_lane(a, rhs.cpu())
    assert chol_lane.chol_factor_lane(a[:0]).shape == (0, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        chol_lane.chol_factor_lane(a.mT)
    with pytest.raises(TypeError):
        chol_lane.chol_factor_lane(a.half())
    # n = 300 has more lower tiles than 384 threads hold at 6 a thread
    with pytest.raises(ValueError, match="lower tiles"):
        chol_lane.chol_factor_lane(torch.eye(300, device=cuda).expand(1, 300, 300).contiguous())
    # chol_solve_factored_lane's launcher takes only solve_geometry's threads and bytes
    x = torch.empty_like(rhs)
    threads, size = chol_lane.solve_geometry(8, torch.float32)
    for ints in ((2, 8, threads * 2, size), (2, 8, threads, size + 4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.launch("chol_solve_factored_lane", (a, rhs, x), ints, a.device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.float64, 1e-10)])
@pytest.mark.parametrize("n_steps", [1, 8])
@pytest.mark.parametrize("b,n", [(4, 5), (130, 17), (257, 93)])
def test_ip_steps_lane_matches_plain(cuda, b, n, n_steps, dtype, tol):
    args = qp_batch(b, n, dtype, n + b, cuda)
    ip_lane.reset_launch_counts()
    got = ip_lane.ip_steps_lane(*args, n_steps)
    want = ip_lane.ip_steps_lane_plain(*args, n_steps)
    torch.cuda.synchronize()
    assert ip_lane.LAUNCHES == {"ip_steps_lane": 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


# n for the fused kernels: each tile count a thread that csrc/ip_lane.cu
# instantiates runs in each dtype (tests/test_torch_ip_lane.py holds the list
# to that), beside the fused fit's n = 93, the resolve's 94 and the IP-loop
# experiment's 95
IP_SIZES = (1, 4, 5, 17, 33, 45, 93, 94, 95, "max")


def _ip_largest(dtype):
    return max(n for n in range(1, 400) if ip_lane.admitted(n, dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.float64, 1e-10)])
@pytest.mark.parametrize("n", IP_SIZES)
def test_ip_kernels_at_every_tile_count(cuda, n, dtype, tol):
    """ip_steps_lane (float32 and float64) and ip_steps_loop (float32)
    against their plain versions, 4 steps on 37 box QPs, at every n of
    IP_SIZES, the largest admitted included; lane 5 has an indefinite P and
    must keep its input. One launch per call."""
    n = _ip_largest(dtype) if n == "max" else n
    args = qp_batch(37, n, dtype, 11 * n, cuda)
    freeze_lane(args, 5)
    pairs = {"ip_steps_lane": (ip_lane.ip_steps_lane, ip_lane.ip_steps_lane_plain)}
    if dtype == torch.float32:
        pairs[ip_loop.NAME] = (ip_loop.ip_steps_loop, ip_loop.ip_steps_loop_plain)
    ip_lane.reset_launch_counts()
    ip_loop.reset_launch_counts()
    for fn, plain in pairs.values():
        got, want = fn(*args, 4), plain(*args, 4)
        for g, w, inp in zip(got, want, args[3:]):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            assert torch.equal(g[5], inp[5]) and torch.isfinite(g).all()
    torch.cuda.synchronize()
    assert {**ip_lane.LAUNCHES, **ip_loop.LAUNCHES} == {
        "ip_steps_lane": 1, ip_loop.NAME: int(dtype == torch.float32)}


def test_ip_steps_lane_freezes_a_failed_lane(cuda):
    """A lane whose H is indefinite keeps its input (the NaN of the factor
    must reach the freeze test); its neighbours step as the plain version."""
    args = qp_batch(5, 17, torch.float32, 3, cuda)
    freeze_lane(args, 1)
    got = ip_lane.ip_steps_lane(*args, 4)
    want = ip_lane.ip_steps_lane_plain(*args, 4)
    for g, w, inp in zip(got, want, args[3:]):
        assert torch.equal(g[1], inp[1]) and torch.equal(w[1], inp[1])
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_ip_steps_lane_bad_inputs(cuda):
    args = qp_batch(2, 8, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ip_lane.ip_steps_lane(args[0].mT, *args[1:], 2)
    with pytest.raises(ValueError):
        ip_lane.ip_steps_lane(args[0], args[1].cpu(), *args[2:], 2)
    with pytest.raises(TypeError):
        ip_lane.ip_steps_lane(*(a.half() for a in args), 2)
    empty = qp_batch(0, 8, torch.float32, 0, cuda)
    assert ip_lane.ip_steps_lane(*empty, 2)[0].shape == (0, 8)


def test_fit_on_card_matches_cpu(cuda):
    """float64 batched fit on the card (f64 kernels) vs on the CPU (plain)."""
    freq = np.logspace(5, -1, 31)
    rng = np.random.default_rng(0)
    taus = 10 ** rng.uniform(-3, 0, 16)
    z = 0.5 + np.stack([1 / (1 + (2j * np.pi * freq * t) ** 0.9) for t in taus])
    z = z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.003
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)
    r_cpu = BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw).fit(
        z, adaptive="staged")
    chol_lane.reset_launch_counts()
    r_gpu = BatchedEISFitter(freq, dtype=torch.float64, device=cuda, **kw).fit(
        z, adaptive="staged", collect="lazy")
    fit_kernels = ("chol_factor_solve_lane", "chol_solve_factored_lane", "chol_solve_lane")
    assert all(chol_lane.LAUNCHES[k] > 0 for k in fit_kernels)
    assert chol_lane.LAUNCHES["chol_factor_lane"] == 0
    assert r_gpu.weights.is_cuda
    np.testing.assert_array_equal(r_gpu.n_iter, r_cpu.n_iter)
    np.testing.assert_allclose(r_gpu.x, r_cpu.x, rtol=1e-6, atol=1e-10)


def test_fused_fit_on_card_matches_cpu(cuda):
    """float64 qp_fused fit on the card (the f64 ip_steps_lane kernel) vs the
    same fit on the CPU (plain steps): same iterations, x within rtol=1e-6."""
    freq = np.logspace(5, -1, 31)
    rng = np.random.default_rng(1)
    taus = 10 ** rng.uniform(-3, 0, 16)
    z = 0.5 + np.stack([1 / (1 + (2j * np.pi * freq * t) ** 0.9) for t in taus])
    z = z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.003
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2,
              qp_fused=True)
    r_cpu = BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw).fit(
        z, adaptive="staged")
    ip_lane.reset_launch_counts()
    r_gpu = BatchedEISFitter(freq, dtype=torch.float64, **kw).fit(z, adaptive="staged")
    assert 0 < ip_lane.LAUNCHES["ip_steps_lane"] <= int(r_gpu.n_iter.max())
    np.testing.assert_array_equal(r_gpu.n_iter, r_cpu.n_iter)
    np.testing.assert_allclose(r_gpu.x, r_cpu.x, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_warm_frame_on_card_matches_cpu(cuda, fused):
    """A float64 frame fitted warm from the previous frame's CPU result, on the
    card (f64 kernels) and on the CPU (plain): same iterations and flags, x
    within rtol=1e-6. The plain path runs the three fit kernels and no fused
    steps; the fused path runs ip_steps_lane once per outer pass, iteration 0
    included."""
    freq, frames = make_frames(16, 31, 2, 0.02)
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2,
              qp_fused=fused)
    cpu = BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw)
    seed = cpu.fit(frames[0])
    r_cpu = cpu.fit(frames[1], warm_from=seed)
    chol_lane.reset_launch_counts()
    ip_lane.reset_launch_counts()
    r_gpu = BatchedEISFitter(freq, dtype=torch.float64, device=cuda, **kw).fit(
        frames[1], warm_from=seed, collect="lazy")
    fit_kernels = ("chol_factor_solve_lane", "chol_solve_factored_lane", "chol_solve_lane")
    assert all(chol_lane.LAUNCHES[k] > 0 for k in fit_kernels)
    passes = int(r_gpu.n_iter.max())
    assert ip_lane.LAUNCHES["ip_steps_lane"] == (passes if fused else 0)
    assert r_gpu.s_vectors.is_cuda
    np.testing.assert_array_equal(r_gpu.n_iter, r_cpu.n_iter)
    np.testing.assert_array_equal(r_gpu.converged, r_cpu.converged)
    np.testing.assert_allclose(r_gpu.x, r_cpu.x, rtol=1e-6, atol=1e-10)


BENCH_KW = dict(qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)


def _assert_same(a, b):
    """Every field of two BatchFitResults bit for bit."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
        elif isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and torch.equal(x, y), f
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_stream_on_card_matches_sequential(cuda, fused):
    """fit_stream on the card, float32, batches of 1024, 512 and 1024 lanes:
    every result bitwise the sequential fit's on the card, lazy fields on the
    card, and each batch's lane kernel launches those of its sequential
    fit."""
    freq = make_batch(1, 71)[0]
    batches = [make_batch(n, 71, seed=20 + i)[1] for i, n in enumerate((1024, 512, 1024))]
    fitter = BatchedEISFitter(freq, dtype=torch.float32, device=cuda, qp_fused=fused,
                              **BENCH_KW)
    with FitLaunches(fitter) as seq_counts:
        seq = [fitter.fit(z, adaptive="staged", collect="lazy") for z in batches]
    with FitLaunches(fitter) as stream_counts:
        stream = list(fitter.fit_stream(batches))
    assert len(stream) == 3
    for a, b in zip(seq, stream):
        _assert_same(a, b)
        assert b.weights.is_cuda and b.s_vectors.is_cuda
    assert stream_counts.per_fit == seq_counts.per_fit
    assert all(c["chol_factor_solve_lane"] > 0 for c in seq_counts.per_fit)
    assert all((c["ip_steps_lane"] > 0) == fused for c in seq_counts.per_fit)
    full = list(fitter.fit_stream(batches[1:], adaptive=False, collect="full"))
    for a, b in zip([fitter.fit(z) for z in batches[1:]], full):
        _assert_same(a, b)


def test_stream_on_card_releases_memory(cuda):
    """Once the stream's results are dropped, the card's allocated memory is
    back where it was; a consumer that stops early leaves no copy in
    flight."""
    freq = make_batch(1, 71)[0]
    batches = [make_batch(n, 71, seed=30 + i)[1] for i, n in enumerate((256, 128, 256))]
    fitter = BatchedEISFitter(freq, dtype=torch.float32, device=cuda, **BENCH_KW)
    fitter.fit(batches[0], collect="lazy")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    held = list(fitter.fit_stream(batches))
    lazy = sum(t.numel() * t.element_size() for r in held for t in (r.weights, r.s_vectors))
    grown = torch.cuda.memory_allocated(cuda) - before
    assert lazy <= grown <= lazy + (1 << 20) * 2 * len(held)
    del held
    assert torch.cuda.memory_allocated(cuda) == before
    gen = fitter.fit_stream(batches)
    first = next(gen)
    gen.close()
    del first, gen
    assert torch.cuda.memory_allocated(cuda) == before


def _f64_batch(b=16, seed=0):
    freq = np.logspace(5, -1, 31)
    rng = np.random.default_rng(seed)
    taus = 10 ** rng.uniform(-3, 0, b)
    z = 0.5 + np.stack([1 / (1 + (2j * np.pi * freq * t) ** 0.9) for t in taus])
    return freq, z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.003


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_history_on_card_matches_cpu(cuda, fused):
    """The float64 history fit on the card against the CPU's: the same
    n_iter and flags at every iteration, every float field of every entry
    within 1e-6 of that entry's max |value| (a lane's x, s, rho or weights at
    one iteration), and the fused fitter's history launches no fused
    steps."""
    freq, z = _f64_batch()
    kw = dict(BENCH_KW, qp_fused=fused)
    r_cpu, h_cpu = BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw).fit(
        z, return_history=True)
    gpu = BatchedEISFitter(freq, dtype=torch.float64, device=cuda, **kw)
    ip_lane.reset_launch_counts()
    r_gpu, h_gpu = gpu.fit(z, return_history=True)
    assert ip_lane.LAUNCHES["ip_steps_lane"] == 0
    np.testing.assert_array_equal(r_gpu.n_iter, r_cpu.n_iter)
    for k, want in h_cpu.items():
        if want.dtype.kind == "f":
            entry_max = np.max(np.abs(want), axis=tuple(range(2, want.ndim)), keepdims=True)
            assert np.all(np.abs(h_gpu[k] - want) <= 1e-6 * entry_max + 1e-12), k
        else:
            np.testing.assert_array_equal(h_gpu[k], want, err_msg=k)


@pytest.mark.parametrize("refine_iters", [0, 3])
def test_param_cov_on_card_matches_cpu(cuda, refine_iters):
    """param_cov in float64 on the card against the CPU's from one result
    (a float32 fit on the card, lazy), within the bounds of
    tests/test_torch_cov.py: P within 1e-6 of each lane's max |P|, the
    covariance within max(1e-6, cond(P) max(eps, dP)) of each lane's max
    |cov|, the CI band and sigma(R_inf) readouts within their first-order
    bounds, and the card's inverse within N eps backward error of the
    card's P."""
    freq, z = _f64_batch(seed=2)
    res = BatchedEISFitter(freq, dtype=torch.float32, device=cuda, **BENCH_KW).fit(
        z, collect="lazy")
    gpu = BatchedEISFitter(freq, dtype=torch.float32, device=cuda, **BENCH_KW)
    cpu = BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **BENCH_KW)
    chol_lane.reset_launch_counts()
    cov_gpu = gpu.param_cov(res, z, scaled=True, refine_iters=refine_iters)
    fit_kernels = ("chol_factor_solve_lane", "chol_solve_factored_lane", "chol_solve_lane")
    assert all((chol_lane.LAUNCHES[k] > 0) == (refine_iters > 0) for k in fit_kernels)
    cov_cpu = cpu.param_cov(res, z, scaled=True, refine_iters=refine_iters)
    p_gpu = gpu._posterior(res, z, refine_iters)[0].cpu().numpy()
    p_cpu = cpu._posterior(res, z, refine_iters)[0].numpy()
    lane_max = lambda a: np.max(np.abs(a), axis=(1, 2))
    eps = np.finfo(float).eps
    d_p = lane_max(p_gpu - p_cpu) / lane_max(p_cpu)
    assert np.all(d_p <= 1e-6)
    bound = np.maximum(1e-6, np.linalg.cond(p_cpu) * np.maximum(eps, d_p))
    err = lane_max(cov_gpu - cov_cpu) / lane_max(cov_cpu)
    assert np.all(np.isfinite(cov_gpu)) and np.all(err <= bound), (err, bound)
    err, bound = readout_errors(cov_gpu, p_gpu, cov_cpu, p_cpu, cov_readouts(cpu))
    assert np.all(err <= bound), (err / bound).max()
    assert np.all(inverse_residual(p_gpu, cov_gpu) <= p_gpu.shape[-1] * eps)


@pytest.fixture(scope="module")
def map64():
    """A 64-observation map (the smooth map of tests/test_resolve_coupled.py)
    fitted in float64 on the CPU: (fitter, result, z, psi)."""
    freq = np.logspace(5, -1, 41)
    tau_super = np.logspace(-7, 2, 91)
    psis = np.linspace(0, 1, 64)
    rng = np.random.default_rng(8)
    z = np.stack([0.4 + (1 + 0.5 * p) / (1 + (2j * np.pi * freq * 10 ** (-3 + 2 * p)) ** 0.85)
                  for p in psis])
    z = z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.004
    fitter = BatchedEISFitter(freq, tau_supergrid=tau_super, dtype=torch.float64, device="cpu")
    return fitter, fitter.fit(z), z, psis


@pytest.mark.parametrize("kw", [{"coupled": True},
                                {"batched": True, "batch_size": 7, "overlap": 2}],
                         ids=["coupled", "windowed"])
def test_resolve_on_card_matches_cpu(cuda, map64, kw):
    """The 64-observation map resolved in float64 on the card
    (chol_factor_lane and chol_solve_factored_lane) and on the CPU (plain),
    as one coupled group and as 13 windows of 7 overlapping by 2: with the
    per-window live masks and the (G*w, nc, nc) kernel batches each window
    takes the CPU's IP iterations, x lies within 1e-8 of max |x|, and every
    Rp within 0.05 of the map's truth 1 + 0.5 psi."""
    fitter, res, z, psis = map64
    r_cpu = resolve_group(fitter, res, z, psi=psis, device="cpu", **kw)
    chol_lane.reset_launch_counts()
    r_gpu = resolve_group(fitter, res, z, psi=psis, device=cuda, **kw)
    assert chol_lane.LAUNCHES["chol_factor_lane"] > 0
    assert chol_lane.LAUNCHES["chol_solve_factored_lane"] > 0
    np.testing.assert_array_equal(r_gpu.info["n_iter"], r_cpu.info["n_iter"])
    if kw.get("coupled"):
        assert r_gpu.info["kkt_residual"] <= r_gpu.info["kkt_tol"]
    else:
        assert r_gpu.info["windows"] == 13
    assert np.max(np.abs(r_gpu.x - r_cpu.x)) < 1e-8 * np.max(np.abs(r_cpu.x))
    assert np.max(np.abs(fitter.predict_r_p(r_gpu) - (1 + 0.5 * psis))) < 0.05


LAYOUT_MODULES = {m.NAME: m for m in (chol_lane_blocked, chol_column, chol_blocked, smem_sol)}


@pytest.mark.parametrize("b,n", [(4, 5), (130, 17), (130, 37), (8192, 93)])
@pytest.mark.parametrize("kernel", list(LAYOUT_MODULES))
def test_layout_kernel_matches_plain(cuda, kernel, b, n):
    """Every variant the layout study times (kb, block_batch, nb; ragged last
    panels included) against the plain version on the same tensors, float32;
    the input is not written, and each call launches once."""
    a, rhs = spd_batch(b, n, torch.float32, n + b, cuda)
    a_in = a.clone()
    module = LAYOUT_MODULES[kernel]
    module.reset_launch_counts()
    want = layouts.plain(kernel, a, rhs)
    fns = layouts.variants(n)[kernel]
    for label, fn in fns.items():
        got = fn(a, rhs)
        if kernel == chol_lane_blocked.NAME:
            torch.testing.assert_close(got[0], want[0], rtol=TOL, atol=TOL)
            torch.testing.assert_close(torch.tril(got[1]), want[1], rtol=TOL, atol=TOL)
            torch.testing.assert_close(torch.triu(got[1], 1), torch.triu(a, 1))
        else:
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    if kernel == smem_sol.NAME:
        torch.testing.assert_close(got, a * smem_sol.sol_weights(n, device=cuda),
                                   rtol=TOL, atol=TOL)
    torch.cuda.synchronize()
    assert torch.equal(a, a_in)
    assert module.LAUNCHES == {kernel: len(fns)}


def _probe_sizes():
    """{tiles a thread: the smallest n that chol_factor_lane's geometry runs
    with that many} in float32, 1 .. MAX_TILES_PER_THREAD."""
    sizes = {}
    for n in range(1, _largest_admitted(torch.float32) + 1):
        sizes.setdefault(chol_lane.reg_geometry(n, torch.float32)[1], n)
    return sizes


@pytest.mark.parametrize("tpt", [1, 2, 3, 4, 5, 6])
def test_probe_at_every_tile_count(cuda, tpt):
    """The probe on chol_factor_lane's register-tiled skeleton, at the
    smallest n of each of its instantiations: a * sol_weights on the lower
    triangle (0.999^(c+1)), the input's upper triangle, the input unchanged."""
    sizes = _probe_sizes()
    assert sorted(sizes) == list(range(1, chol_lane.MAX_TILES_PER_THREAD[torch.float32] + 1))
    n = sizes[tpt]
    a, _ = spd_batch(7, n, torch.float32, n, cuda)
    a_in = a.clone()
    o = smem_sol.smem_sol(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, a * smem_sol.sol_weights(n, device=cuda), rtol=TOL, atol=TOL)
    assert torch.equal(torch.triu(o, 1), torch.triu(a, 1))
    assert torch.equal(a, a_in)
    # no more blocks an SM than chol_factor_lane (its launcher pads the
    # probe's shared memory), and as many at the fit's n = 93
    probe, factor = smem_sol.occupancy(n)
    assert 0 < probe <= factor, (n, probe, factor)
    probe, factor = smem_sol.occupancy(93)
    assert probe == factor > 0


def test_layout_pivot_contracts(cuda):
    """The panel-blocked factor keeps the lane kernels' NaN from a
    non-positive pivot on, at every panel width the tests take; the column
    and blocked solves give a zero column, finite x as their plain version,
    and x = b where every pivot fails, at every block_batch the column solve
    is tested at, and the blocked solve at nb = 3, 5, 16 and n with a pivot
    failing inside a panel and at a panel's first column."""
    a, rhs = spd_batch(4, 17, torch.float32, 7, cuda)
    a[1, 5, 5] = -1.0
    a[2] = -a[2]
    for kb in LANE_BLOCKED_KB:
        x, l = chol_lane_blocked.chol_factor_solve_lane_blocked(a, rhs, kb=kb)
        assert torch.isnan(x[1]).all() and torch.isnan(x[2]).all()
        assert torch.isfinite(x[0]).all() and torch.isfinite(x[3]).all()
        assert torch.isnan(torch.diagonal(l[1])[5:]).all()
        assert torch.isfinite(torch.diagonal(l[1])[:5]).all()
        assert torch.isnan(torch.diagonal(l[2])).all()
        assert torch.isfinite(torch.tril(l[0])).all() and torch.isfinite(torch.tril(l[3])).all()
        assert torch.equal(torch.triu(l, 1), torch.triu(a, 1))
    want = chol_column.chol_solve_batched_plain(a, rhs)
    assert torch.equal(want[2], rhs[2])
    solves = [lambda k=k: chol_column.chol_solve_batched(a, rhs, block_batch=k)
              for k in _column_block_batches(17)]
    solves += [lambda nb=nb: chol_blocked.chol_solve_blocked(a, rhs, nb=nb) for nb in (4, 5, 16)]
    for solve in solves:
        x = solve()
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, want, rtol=TOL, atol=TOL)
        assert torch.equal(x[2], rhs[2])
    for nb in (3, 5, 16, 17):
        # lane 1 fails inside a panel, lane 3 at a panel's first column
        first = nb if nb < 17 else 0
        inside = first + 1 if first + 1 < 17 else 8
        a, rhs = spd_batch(4, 17, torch.float32, 7, cuda)
        a[1, inside, inside] = -1.0
        a[2] = -a[2]
        a[3, first, first] = -1.0
        want = chol_column.chol_solve_batched_plain(a, rhs)
        assert torch.equal(want[2], rhs[2])
        for k in _column_block_batches(17):
            x = chol_blocked.chol_solve_blocked(a, rhs, block_batch=k, nb=nb)
            assert torch.isfinite(x).all()
            torch.testing.assert_close(x, want, rtol=TOL, atol=TOL)
            assert torch.equal(x[2], rhs[2])


def test_layout_bad_inputs(cuda):
    a, rhs = spd_batch(2, 8, torch.float32, 0, cuda)
    calls = {chol_lane_blocked.NAME: chol_lane_blocked.chol_factor_solve_lane_blocked,
             chol_column.NAME: chol_column.chol_solve_batched,
             chol_blocked.NAME: chol_blocked.chol_solve_blocked,
             smem_sol.NAME: lambda a, b: smem_sol.smem_sol(a)}
    for name, fn in calls.items():
        with pytest.raises(TypeError):
            fn(a.double(), rhs.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(a.mT, rhs)
        if name != smem_sol.NAME:
            with pytest.raises(ValueError):
                fn(a, rhs.cpu())
        out = fn(a[:0], rhs[:0])
        assert (out[0] if name == chol_lane_blocked.NAME else out).shape[0] == 0
    # at n = 93, 12 packed triangles fit one block, 13 do not, in both warp
    # layouts
    big, rhs_big = spd_batch(1, 93, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        chol_column.chol_solve_batched(big, rhs_big, block_batch=13)
    with pytest.raises(ValueError, match="shared memory"):
        chol_blocked.chol_solve_blocked(big, rhs_big, block_batch=13)
    # the launchers refuse what their wrappers refuse
    x = torch.empty_like(rhs_big)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch(chol_column.NAME, (big, rhs_big, x), (1, 93, 33), big.device)
    for ints in ((1, 93, 33, 16), (1, 93, 8, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.launch(chol_blocked.NAME, (big, rhs_big, x), ints, big.device)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch(chol_lane_blocked.NAME, (big, rhs_big, x, big.clone()), (1, 93, 33, 64),
                      big.device)


LANE_BLOCKED_KB = (1, 3, 4, 5, 8, 16, 32)


def _column_block_batches(n):
    """1, 3, the default and the most that fit, as far as they fit."""
    most = chol_column.max_block_batch(n)
    return sorted(k for k in {1, 3, chol_column.block_batch_for(n), most} if k <= most)


def _largest_layout_n(kernel):
    if kernel in (chol_column.NAME, chol_blocked.NAME):
        return max(n for n in range(1, 400) if chol_column.max_block_batch(n) >= 1)
    return _largest_admitted(torch.float32)


@pytest.mark.parametrize("b", [1, 133])
@pytest.mark.parametrize("n", [1, 4, 5, 17, 33, 93, 94, "max"])
def test_column_solve_kernel(cuda, n, b):
    """chol_solve_batched (a warp per matrix, the packed lower triangle)
    against its plain version on either side of a 4-column group and of a
    warp's 32 rows, at 93/94 and the largest n one block's shared memory
    takes (335): x within the tolerance at every block_batch tested, the
    same bits at each (block_batch changes no result), the input
    unchanged, one launch a call."""
    n = _largest_layout_n(chol_column.NAME) if n == "max" else n
    a, rhs = spd_batch(b, n, torch.float32, 13 * n + b, cuda)
    a_in = a.clone()
    want = chol_column.chol_solve_batched_plain(a, rhs)
    chol_column.reset_launch_counts()
    block_batches = _column_block_batches(n)
    xs = [chol_column.chol_solve_batched(a, rhs, block_batch=k) for k in block_batches]
    torch.cuda.synchronize()
    for x in xs:
        torch.testing.assert_close(x, want, rtol=TOL, atol=TOL)
        assert torch.equal(x, xs[0])
    assert torch.equal(a, a_in)
    assert chol_column.LAUNCHES == {chol_column.NAME: len(block_batches)}


@pytest.mark.parametrize("b", [1, 133])
@pytest.mark.parametrize("n", [1, 4, 5, 17, 31, 32, 33, 93, "max"])
@pytest.mark.parametrize("nb", [1, 3, 4, 5, 8, 16, "n"])
def test_blocked_solve_kernel(cuda, nb, n, b):
    """chol_solve_blocked (the column solve's kernel in panels of nb columns;
    panels ending inside a group of 4 columns where nb is not a multiple of
    4) against its plain version up to the largest n one block's shared
    memory takes (335): x within the tolerance at block_batch 1, the default
    and the most that fit, the same bits at each (block_batch changes no
    result), and at one panel (nb = n) chol_solve_batched's bits; the input
    unchanged, one launch a call."""
    n = _largest_layout_n(chol_blocked.NAME) if n == "max" else n
    nb = n if nb == "n" else nb
    a, rhs = spd_batch(b, n, torch.float32, 19 * n + b, cuda)
    a_in = a.clone()
    want = chol_blocked.chol_solve_blocked_plain(a, rhs)
    chol_blocked.reset_launch_counts()
    most = chol_column.max_block_batch(n)
    block_batches = sorted({1, chol_blocked.block_batch_for(n), most})
    xs = [chol_blocked.chol_solve_blocked(a, rhs, block_batch=k, nb=nb) for k in block_batches]
    torch.cuda.synchronize()
    for x in xs:
        torch.testing.assert_close(x, want, rtol=TOL, atol=TOL)
        assert torch.equal(x, xs[0])
    if nb >= n:
        assert torch.equal(xs[0], chol_column.chol_solve_batched(a, rhs))
    assert torch.equal(a, a_in)
    assert chol_blocked.LAUNCHES == {chol_blocked.NAME: len(block_batches)}


@pytest.mark.parametrize("b", [1, 133])
@pytest.mark.parametrize("n", [1, 4, 5, 17, 33, 93, 94, "max"])
@pytest.mark.parametrize("kb", LANE_BLOCKED_KB)
def test_lane_blocked_kernel(cuda, kb, n, b):
    """chol_factor_solve_lane_blocked (chol_factor_solve_lane's register
    tiles, panels of kb columns; panels ending inside a tile column where kb
    is not a multiple of 4) against its plain version up to the largest n
    the tile rule takes (268): x and L's lower triangle within the
    tolerance, L's upper triangle the input's, the input unchanged, one
    launch."""
    n = _largest_layout_n(chol_lane_blocked.NAME) if n == "max" else n
    a, rhs = spd_batch(b, n, torch.float32, 17 * n + b, cuda)
    a_in = a.clone()
    x_p, l_p = chol_lane_blocked.chol_factor_solve_lane_blocked_plain(a, rhs)
    chol_lane_blocked.reset_launch_counts()
    x, l = chol_lane_blocked.chol_factor_solve_lane_blocked(a, rhs, kb=kb)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, x_p, rtol=TOL, atol=TOL)
    torch.testing.assert_close(torch.tril(l), l_p, rtol=TOL, atol=TOL)
    assert torch.equal(torch.triu(l, 1), torch.triu(a, 1))
    assert torch.equal(a, a_in)
    assert chol_lane_blocked.LAUNCHES == {chol_lane_blocked.NAME: 1}


@pytest.mark.parametrize("b,n,n_steps", [(8192, 93, 4), (1024, 95, 8), (130, 17, 8)])
def test_ip_steps_loop_matches_plain(cuda, b, n, n_steps):
    """The full-step kernel against its plain version on the experiment's
    problems at the fused fit's shape, the experiment's own and a small one,
    and on box QPs with lb = -1 entries; one launch per call."""
    ip_loop.reset_launch_counts()
    for args in (ip_loop.make_problems(b, n, seed=n + b, device=cuda),
                 qp_batch(b, n, torch.float32, n + b, cuda)):
        got = ip_loop.ip_steps_loop(*args, n_steps)
        want = ip_loop.ip_steps_loop_plain(*args, n_steps)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    torch.cuda.synchronize()
    assert ip_loop.LAUNCHES == {ip_loop.NAME: 2}


def test_ip_steps_loop_freezes_a_failed_lane(cuda):
    """An indefinite lane keeps its input under the full-step rule too: the
    NaN ratio reaches the freeze test."""
    args = qp_batch(5, 17, torch.float32, 3, cuda)
    freeze_lane(args, 1)
    got = ip_loop.ip_steps_loop(*args, 4)
    want = ip_loop.ip_steps_loop_plain(*args, 4)
    for g, w, inp in zip(got, want, args[3:]):
        assert torch.equal(g[1], inp[1]) and torch.equal(w[1], inp[1])
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_ip_steps_loop_bad_inputs(cuda):
    args = qp_batch(2, 8, torch.float32, 0, cuda)
    with pytest.raises(TypeError):
        ip_loop.ip_steps_loop(*(a.double() for a in args), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ip_loop.ip_steps_loop(args[0].mT, *args[1:], 2)
    with pytest.raises(ValueError):
        ip_loop.ip_steps_loop(args[0], args[1].cpu(), *args[2:], 2)
    with pytest.raises(ValueError):
        ip_loop.ip_steps_loop(*args, -1)
    big = qp_batch(1, _ip_largest(torch.float32) + 1, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="lower tiles"):
        ip_loop.ip_steps_loop(*big, 2)
    for got, inp in zip(ip_loop.ip_steps_loop(*args, 0), args[3:]):
        assert torch.equal(got, inp)
    assert ip_loop.ip_steps_loop(*qp_batch(0, 8, torch.float32, 0, cuda), 2)[0].shape == (0, 8)


def test_ip_steps_lane_at_the_fused_fit_shape(cuda):
    """The production fused kernel, which shares its source with
    ip_steps_loop, still matches its plain version at (8192, 93, 4), and the
    two rules part only where the plain versions part."""
    args = qp_batch(8192, 93, torch.float32, 8192 + 93, cuda)
    got = ip_lane.ip_steps_lane(*args, 4)
    want = ip_lane.ip_steps_lane_plain(*args, 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    full = ip_loop.ip_steps_loop(*args, 1)
    capped = ip_lane.ip_steps_lane(*args, 1)
    full_p = ip_loop.ip_steps_loop_plain(*args, 1)
    capped_p = ip_lane.ip_steps_lane_plain(*args, 1)
    for f, c, fp, cp in zip(full, capped, full_p, capped_p):
        torch.testing.assert_close(f - c, fp - cp, rtol=TOL, atol=TOL)


FIT_KERNELS = ("chol_factor_solve_lane", "chol_solve_factored_lane", "chol_solve_lane")


def test_kernels_on_ragged_shaped_lanes(cuda):
    """#1-#3 on the ragged fit's shape (B = 768, n = 94, float32) with each
    lane's padded columns pinned as the ragged fit pins them (zero coupling,
    unit diagonal, zero right-hand side): within TOL of the plain versions,
    and the padded tail of x exactly zero."""
    b, n = 768, 94
    a, rhs = spd_batch(b, n, torch.float64, 768 + 94, cuda)
    d = torch.diagonal(a, dim1=-2, dim2=-1).rsqrt()
    a = a * d[:, :, None] * d[:, None, :]
    widths = torch.tensor([85, 89, 94], device=cuda)[torch.arange(b, device=cuda) % 3]
    col = (torch.arange(n, device=cuda)[None, :] < widths[:, None]).to(a.dtype)
    a = a * col[:, :, None] * col[:, None, :] + torch.diag_embed(1.0 - col)
    a, rhs, col = a.float(), (rhs * col).float(), col.float()
    x, l = chol_lane.chol_factor_solve_lane(a, rhs)
    x_p, l_p = chol_lane.chol_factor_solve_lane_plain(a, rhs)
    torch.testing.assert_close(x, x_p, rtol=TOL, atol=TOL)
    torch.testing.assert_close(torch.tril(l), l_p, rtol=TOL, atol=TOL)
    x2 = chol_lane.chol_solve_factored_lane(l, rhs)
    torch.testing.assert_close(x2, chol_lane.chol_solve_factored_lane_plain(l_p, rhs),
                               rtol=TOL, atol=TOL)
    x3 = chol_lane.chol_solve_lane(a, rhs)
    torch.testing.assert_close(x3, chol_lane.chol_solve_lane_plain(a, rhs), rtol=TOL, atol=TOL)
    for xs in (x, x2, x3):
        assert torch.all(xs[col == 0] == 0)


def _drt_qp(n_tau):
    """The equilibrated final QP of a CPU float64 DRT fit of the golden
    spectrum on a basis of n_tau points (n = n_tau + 2), as (P, q) of one
    lane in float64."""
    freq, z, _ = golden_fit()
    kw = {} if n_tau == 91 else {"fixed_basis_tau": np.logspace(-8, 3, n_tau)}
    drt = DRT(device="cpu", **kw).fit_eis(freq, z, **GOLDEN_HYPERS)
    p = torch.as_tensor(drt.qphb_params["p_matrix"])[None]
    q = torch.as_tensor(drt.qphb_params["q_vector"])[None]
    d = torch.diagonal(p, dim1=-2, dim2=-1).rsqrt()
    return p * d[:, :, None] * d[:, None, :], q * d


@pytest.mark.parametrize("n_tau", [91, 186], ids=["n93", "n188"])
def test_kernels_on_one_drt_lane(cuda, n_tau):
    """#1-#3 at B = 1 in float64 on a single-spectrum DRT's own QP (n = 93 at
    the default 10 points a decade; n = 188, the largest the float64 tile
    rule admits). These P reach cond 1e9, so each kernel is held to what a
    backward-stable solve guarantees: its factor and x backward errors below
    10 n eps, and x within 10 n eps cond(P) of the plain version's."""
    p, q = (t.to(cuda) for t in _drt_qp(n_tau))
    n = n_tau + 2
    assert p.shape == (1, n, n) and chol_lane.admitted(n, p.dtype)
    eps = torch.finfo(p.dtype).eps
    cond = float(torch.linalg.cond(p[0].cpu()))
    x, l = chol_lane.chol_factor_solve_lane(p, q)
    x_p, _ = chol_lane.chol_factor_solve_lane_plain(p, q)
    lo = torch.tril(l[0])
    assert float(torch.linalg.norm(lo @ lo.T - p[0]) / torch.linalg.norm(p[0])) < 10 * n * eps
    for xs in (x, chol_lane.chol_solve_factored_lane(l, q), chol_lane.chol_solve_lane(p, q)):
        back = torch.linalg.norm(p[0] @ xs[0] - q[0]) / (
            torch.linalg.norm(p[0]) * torch.linalg.norm(xs[0]) + torch.linalg.norm(q[0]))
        assert float(back) < 10 * n * eps
        assert float((xs - x_p).abs().max() / x_p.abs().max()) < 10 * n * eps * cond


def test_drt_on_card_matches_cpu(cuda):
    """DRT.fit_eis on the card (float64, the lane kernels at one lane)
    against the CPU: the same iterations and flag, x within 1e-6 of max |x|;
    every fit kernel launched. A basis whose QP exceeds the float64 tile rule
    raises on the card."""
    freq, z, _ = golden_fit()
    cpu = DRT(device="cpu").fit_eis(freq, z, **GOLDEN_HYPERS)
    chol_lane.reset_launch_counts()
    card = DRT().fit_eis(freq, z, **GOLDEN_HYPERS)
    assert all(chol_lane.LAUNCHES[k] > 0 for k in FIT_KERNELS)
    assert card.qphb_params["n_iter"] == cpu.qphb_params["n_iter"]
    assert card.qphb_params["converged"] == cpu.qphb_params["converged"]
    x, x_c = card.fit_parameters["x"], cpu.fit_parameters["x"]
    assert np.max(np.abs(x - x_c)) <= 1e-6 * np.max(np.abs(x_c))
    with pytest.raises(NotImplementedError, match="item 8"):
        DRT(fixed_basis_tau=np.logspace(-8, 3, 187)).fit_eis(freq, z)


def test_ragged_on_card_matches_cpu(cuda):
    """The ragged fit in float64 on the card against the CPU on 24 of the het
    leg's spectra (three grids): the same iterations, x within 1e-6 of each
    observation's max, padded tails exactly zero; in float32 the tails are
    exactly zero too and every fit kernel launched."""
    obs = make_het_eis()[0][:24]
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4)
    r_cpu = BatchedRaggedFitter(TAU_SUPER, device="cpu", **kw).fit(obs)
    r_gpu = BatchedRaggedFitter(TAU_SUPER, **kw).fit(obs)
    np.testing.assert_array_equal(r_gpu.n_iter, r_cpu.n_iter)
    for k in range(len(obs)):
        assert np.max(np.abs(r_gpu.x[k] - r_cpu.x[k])) <= 1e-6 * np.max(np.abs(r_cpu.x[k]))
    chol_lane.reset_launch_counts()
    r32 = BatchedRaggedFitter(TAU_SUPER, dtype=torch.float32, **kw).fit(obs, adaptive="staged")
    assert all(chol_lane.LAUNCHES[k] > 0 for k in FIT_KERNELS)
    assert np.all(np.isfinite(r32.x_raw))
    for res in (r_gpu, r32):
        for k, (left, right) in enumerate(res.tau_indices):
            assert np.all(res.x[k][right - left:] == 0.0)


@pytest.mark.parametrize("kw", [{}, {"hybrid_weight_factor_method": "weight"},
                                {"hybrid_weight_factor_method": "rp"}],
                         ids=["none", "weight", "rp"])
def test_hybrid_drt_on_card_matches_cpu(cuda, kw):
    """DRT.fit_hybrid on the card (float64, n = 91, the lane kernels at one
    lane) against the CPU on tests/test_chrono_hybrid.py's data: the same
    iterations and flag, x within 1e-6 of max |x|; every fit kernel
    launched; and fit_chrono the same way."""
    t, i, v, f, z = hybrid_data(seed=0)
    for fit, data in (("fit_hybrid", (t, i, v, f, z)), ("fit_chrono", (t, i, v))):
        cpu = getattr(DRT(warn=False, device="cpu"), fit)(*data, **kw)
        chol_lane.reset_launch_counts()
        card = getattr(DRT(warn=False), fit)(*data, **kw)
        assert all(chol_lane.LAUNCHES[k] > 0 for k in FIT_KERNELS)
        assert card.qphb_params["n_iter"] == cpu.qphb_params["n_iter"]
        assert card.qphb_params["converged"] == cpu.qphb_params["converged"]
        x, x_c = card.qphb_params["x_raw"], cpu.qphb_params["x_raw"]
        assert np.max(np.abs(x - x_c)) <= 1e-6 * np.max(np.abs(x_c))
        if kw:
            break


def _held_to_sensitivity(got, want, want_ulp):
    """A card fit ``got`` against the CPU fit ``want``, each lane held by its
    own sensitivity: x within max(1e-6, 10 d) of the lane's max |x|, where d
    is how far the CPU fit of the data moved by one ulp (``want_ulp``) lands
    from ``want``; the same n_iter on the lanes whose n_iter that move
    keeps. A lane that ends on a limit cycle at max_iter moves by percents
    under any rounding change, in the JAX package too (PERF.md, Findings PR
    15); a converged lane moves by 1e-13. Returns the number of lanes held
    at 1e-6."""
    tight = 0
    for k in range(len(want.n_iter)):
        scale = np.max(np.abs(want.x_raw[k]))
        d = np.max(np.abs(want_ulp.x_raw[k] - want.x_raw[k])) / scale
        assert np.max(np.abs(got.x_raw[k] - want.x_raw[k])) <= max(1e-6, 10 * d) * scale, k
        if want_ulp.n_iter[k] == want.n_iter[k]:
            assert got.n_iter[k] == want.n_iter[k], k
        tight += 10 * d <= 1e-6
    return tight


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_hybrid_fitter_on_card_matches_cpu(cuda, fused):
    """BatchedHybridFitter in float64 on the card against the CPU on 32 of
    make_hybrid_batch's observations, cold and warm from the CPU's cold fit
    on a next frame (the same lanes, new noise; one seed for both, as
    test_warm_frame_on_card_matches_cpu), each lane held by its one-ulp
    sensitivity (``_held_to_sensitivity``), most of them at 1e-6; in float32
    every fit kernel (and #5 on the fused path) launched, and the
    coefficients finite."""
    t, i, f, v, z = make_hybrid_batch(32)
    v1, z1 = make_hybrid_batch(32, seed=4)[3:]
    ulp = 1 + np.finfo(float).eps
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4, qp_fused=fused, pred_stop=True,
              pred_rtol=3e-2)
    cpu = BatchedHybridFitter(t, i, f, device="cpu", **kw)
    card = BatchedHybridFitter(t, i, f, **kw)
    r_cpu = cpu.fit(v, z)
    assert _held_to_sensitivity(card.fit(v, z), r_cpu, cpu.fit(v * ulp, z * ulp)) >= 24
    w_cpu = cpu.fit(v1, z1, warm_from=r_cpu)
    w_ulp = cpu.fit(v1 * ulp, z1 * ulp, warm_from=r_cpu)
    assert _held_to_sensitivity(card.fit(v1, z1, warm_from=r_cpu), w_cpu, w_ulp) >= 24
    chol_lane.reset_launch_counts()
    ip_lane.reset_launch_counts()
    r32 = BatchedHybridFitter(t, i, f, dtype=torch.float32, **kw).fit(v, z, collect="lazy")
    assert all(chol_lane.LAUNCHES[k] > 0 for k in FIT_KERNELS)
    assert (ip_lane.LAUNCHES["ip_steps_lane"] > 0) == fused
    assert np.all(np.isfinite(r32.x_raw)) and r32.weights.is_cuda


def test_ragged_hybrid_on_card_matches_cpu(cuda):
    """The ragged fit of 16 of the het leg's hybrid observations (two
    protocols) in float64 on the card against the CPU: the same iterations,
    x within 1e-6 of each observation's max, padded tails exactly zero; in
    float32 every fit kernel launched and the tails exactly zero."""
    obs = make_het_hybrid()[0][:16]
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4)
    r_cpu = BatchedRaggedFitter(TAU_SUPER, device="cpu", **kw).fit(obs)
    r_gpu = BatchedRaggedFitter(TAU_SUPER, **kw).fit(obs)
    np.testing.assert_array_equal(r_gpu.n_iter, r_cpu.n_iter)
    for k in range(len(obs)):
        assert np.max(np.abs(r_gpu.x[k] - r_cpu.x[k])) <= 1e-6 * np.max(np.abs(r_cpu.x[k]))
    chol_lane.reset_launch_counts()
    r32 = BatchedRaggedFitter(TAU_SUPER, dtype=torch.float32, **kw).fit(obs)
    assert all(chol_lane.LAUNCHES[k] > 0 for k in FIT_KERNELS)
    for res in (r_gpu, r32):
        assert all(np.all(res.x[k][r - l:] == 0.0) for k, (l, r) in enumerate(res.tau_indices))
