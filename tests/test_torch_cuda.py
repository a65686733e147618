"""GPU tests of the port: the CUDA kernels against their plain versions (the
kernels of hybdrt_torch/experiments/ too), the batched fit
(plain and fused warm QPs) and the group resolve (coupled and windowed) on
the card against the same computations on the CPU.

Every test here is marked ``cuda`` and skips where no CUDA device is present.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from hybdrt_torch import BatchedEISFitter, resolve_group
from hybdrt_torch.csrc import build as _build
from hybdrt_torch.experiments import (chol_blocked, chol_column, chol_lane_blocked, ip_loop,
                                      layouts, smem_sol)
from hybdrt_torch.ops import chol_lane, ip_lane
from hybdrt_torch.utils.probe import freeze_lane, qp_batch, spd_batch

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
    non-positive pivot on; the column and blocked solves give a zero column,
    finite x as their plain version, and x = b where every pivot fails."""
    a, rhs = spd_batch(4, 17, torch.float32, 7, cuda)
    a[1, 5, 5] = -1.0
    a[2] = -a[2]
    for kb in (4, 8, 16):
        x, l = chol_lane_blocked.chol_factor_solve_lane_blocked(a, rhs, kb=kb)
        assert torch.isnan(x[1]).all() and torch.isnan(x[2]).all()
        assert torch.isfinite(x[0]).all() and torch.isfinite(x[3]).all()
        assert torch.isnan(torch.diagonal(l[1])[5:]).all()
        assert torch.isfinite(torch.diagonal(l[1])[:5]).all()
        assert torch.isnan(torch.diagonal(l[2])).all()
        assert torch.isfinite(torch.tril(l[0])).all() and torch.isfinite(torch.tril(l[3])).all()
    want = chol_column.chol_solve_batched_plain(a, rhs)
    assert torch.equal(want[2], rhs[2])
    solves = [lambda k=k: chol_column.chol_solve_batched(a, rhs, block_batch=k) for k in (1, 3)]
    solves += [lambda nb=nb: chol_blocked.chol_solve_blocked(a, rhs, nb=nb) for nb in (4, 5, 16)]
    for solve in solves:
        x = solve()
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
    big, rhs_big = spd_batch(1, 93, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        chol_column.chol_solve_batched(big, rhs_big, block_batch=7)


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
