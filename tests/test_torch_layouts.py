"""Port parity: the Cholesky layout study of hybdrt_torch/experiments/.

On the CPU each wrapper runs its plain PyTorch version; that version is held
to the TPU experiment kernel it replaces, run in Pallas interpret mode, on
the same seeded inputs, float32, rtol = atol = 2e-4 (a factor on its lower
triangle only). The experiment files are loaded by path: ``experiments/`` is
not a package. The CUDA kernels themselves are held to these plain versions
on a GPU by tests/test_torch_cuda.py.
"""
import hashlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hybdrt_torch.experiments import (chol_blocked, chol_column, chol_lane_blocked, layouts,
                                      smem_sol)
from hybdrt_torch.ops import chol_lane

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

TOL = 2e-4
EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_experiment_{name}",
                                                  EXPERIMENTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_LANE_BLOCKED = _load("pallas_chol_lane_blocked")
_COLUMN = _load("pallas_chol_column")
_BLOCKED = _load("pallas_chol_blocked")

def _spd_batch(b, n, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n)).astype(np.float32)
    a = g @ np.swapaxes(g, 1, 2) + n * np.eye(n, dtype=np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    return a, rhs


BATCHES = (4, 130)


def _run_jax(kernel, param, a, rhs):
    aj, rj = jnp.asarray(a), jnp.asarray(rhs)
    if kernel == "lane_blocked":
        out = _LANE_BLOCKED.chol_factor_solve_lane_blocked(aj, rj, kb=param, interpret=True)
    elif kernel == "column":
        out = _COLUMN.chol_solve_batched(aj, rj, interpret=True)
    else:
        out = _BLOCKED.chol_solve_blocked(aj, rj, nb=param, interpret=True)
    return tuple(np.asarray(o) for o in out) if isinstance(out, (tuple, list)) \
        else np.asarray(out)


# JAX outputs per kernel, parameter and inputs: the interpret runs take
# seconds, mostly tracing for the shape
_JAX = {}


def _jax(kernel, param, a, rhs):
    key = (kernel, param, hashlib.sha256(a.tobytes() + rhs.tobytes()).hexdigest())
    if key not in _JAX:
        _JAX[key] = _run_jax(kernel, param, a, rhs)
    return _JAX[key]


def _jax_seeded(kernel, param, n, b):
    """The JAX outputs of the seeded batch (b, n): the inputs of every batch
    size of one n go through one interpret call (the lanes are independent),
    split by batch afterwards."""
    key = (kernel, param, n, b)
    if key not in _JAX:
        cases = [_spd_batch(bb, n, seed=n + bb) for bb in BATCHES]
        out = _run_jax(kernel, param, np.concatenate([c[0] for c in cases]),
                       np.concatenate([c[1] for c in cases]))
        start = 0
        for bb in BATCHES:
            _JAX[(kernel, param, n, bb)] = tuple(o[start:start + bb] for o in out) \
                if isinstance(out, tuple) else out[start:start + bb]
            start += bb
    return _JAX[key]


def _failing_batch():
    """Lane 1 fails at pivot 4, lane 2 (negative definite) at every pivot."""
    a, rhs = _spd_batch(4, 9, seed=1)
    a[1, 4, 4] = -1.0
    a[2] = -a[2]
    return a, rhs


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kb", [4, 8])
@pytest.mark.parametrize("n", [5, 16, 17, 37])
@pytest.mark.parametrize("b", BATCHES)
def test_lane_blocked_matches_pallas_interpret(kb, n, b):
    a, rhs = _spd_batch(b, n, seed=n + b)
    x, l = chol_lane_blocked.chol_factor_solve_lane_blocked(
        torch.from_numpy(a), torch.from_numpy(rhs), kb=kb)
    x_j, l_j = _jax_seeded("lane_blocked", kb, n, b)
    _close(x.numpy(), x_j)
    _close(np.tril(l.numpy()), np.tril(l_j))


@pytest.mark.parametrize("n", [5, 16, 17, 37])
@pytest.mark.parametrize("b", BATCHES)
def test_column_matches_pallas_interpret(n, b):
    a, rhs = _spd_batch(b, n, seed=n + b)
    x = chol_column.chol_solve_batched(torch.from_numpy(a), torch.from_numpy(rhs))
    _close(x.numpy(), _jax_seeded("column", None, n, b))


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("n", [5, 16, 17, 37])
@pytest.mark.parametrize("b", BATCHES)
def test_blocked_matches_pallas_interpret(nb, n, b):
    a, rhs = _spd_batch(b, n, seed=n + b)
    x = chol_blocked.chol_solve_blocked(torch.from_numpy(a), torch.from_numpy(rhs), nb=nb)
    _close(x.numpy(), _jax_seeded("blocked", nb, n, b))


@pytest.mark.parametrize("n", [5, 16, 17, 37])
@pytest.mark.parametrize("b", [4, 130])
def test_probe_matches_closed_form(n, b):
    """The TPU probe (experiments/vmem_sol.py:53-60) scales column j from the
    diagonal down and then the trailing block right of it, once each per
    column j, so element (r, c) of the lower triangle is scaled once at
    j = c and once at every j < c: 0.999^(c+1). The port's probe touches
    the lower triangle only (the port's factor updates no other), so the
    upper triangle keeps the input."""
    a, _ = _spd_batch(b, n, seed=n + b)
    at = torch.from_numpy(a)
    o = smem_sol.smem_sol(at).numpy()
    c = np.arange(n)
    closed = a * np.where(c[:, None] >= c[None, :], 0.999 ** (c[None, :] + 1.0), 1.0)
    _close(o, closed)
    np.testing.assert_array_equal(np.triu(o, 1), np.triu(a, 1))
    _close((at * smem_sol.sol_weights(n)).numpy(), closed)


@pytest.mark.parametrize("kb", [4, 8])
def test_lane_blocked_non_positive_pivot_gives_nan(kb):
    a, rhs = _failing_batch()
    x, l = chol_lane_blocked.chol_factor_solve_lane_blocked(
        torch.from_numpy(a), torch.from_numpy(rhs), kb=kb)
    x_j, l_j = _jax("lane_blocked", kb, a, rhs)
    for xs in (x.numpy(), x_j):
        assert np.isnan(xs[1]).all() and np.isnan(xs[2]).all()
        assert np.isfinite(xs[0]).all() and np.isfinite(xs[3]).all()
    # NaN from the failed pivot on (the plain version, as chol_factor_solve_lane's,
    # fills the whole failed lane)
    for ls in (l.numpy(), l_j):
        assert np.isnan(np.diagonal(ls[1])[4:]).all() and np.isnan(np.diagonal(ls[2])).all()
        assert np.isfinite(np.tril(ls[0])).all() and np.isfinite(np.tril(ls[3])).all()
    assert np.isfinite(np.diagonal(l_j[1])[:4]).all()
    _close(x.numpy()[[0, 3]], x_j[[0, 3]])


@pytest.mark.parametrize("kernel,param", [("column", None), ("blocked", 4), ("blocked", 8)])
def test_zero_pivot_gives_finite_x(kernel, param):
    """A non-positive pivot gives a zero column and no update, and the
    substitutions divide by 1 there: finite x, equal to the JAX kernels',
    and x = b in the lane where every pivot fails."""
    a, rhs = _failing_batch()
    at, rt = torch.from_numpy(a), torch.from_numpy(rhs)
    if kernel == "column":
        x = chol_column.chol_solve_batched(at, rt)
    else:
        x = chol_blocked.chol_solve_blocked(at, rt, nb=param)
    x_j = _jax(kernel, param, a, rhs)
    assert np.isfinite(x.numpy()).all() and np.isfinite(x_j).all()
    _close(x.numpy(), x_j)
    np.testing.assert_array_equal(x.numpy()[2], rhs[2])
    _close(x_j[2], rhs[2])
    l = chol_column.factor_zero_pivot_plain(at)
    assert (l[1, :, 4] == 0).all() and (l[2] == 0).all()


def test_study_variants_match_pallas_interpret():
    """The study's table: every variant of each layout (kb, block_batch,
    nb) computes its TPU kernel's function."""
    # the inputs of the (4, 17) cases above, whose JAX outputs are cached
    a, rhs = _spd_batch(4, 17, seed=4 + 17)
    at, rt = torch.from_numpy(a), torch.from_numpy(rhs)
    x_lane, l_lane = _jax("lane_blocked", 8, a, rhs)
    x_solve = _jax("column", None, a, rhs)
    table = layouts.variants(17)
    assert set(table["chol_factor_solve_lane_blocked"]) == {"kb=4", "kb=8", "kb=16"}
    # 1, 2, 4, 6, the default 8 and the most that fit, 32 (MAX_BLOCK_BATCH)
    assert set(table["chol_solve_batched"]) == {f"block_batch={k}"
                                                for k in (1, 2, 4, 6, 8, 32)}
    for label, fn in table["chol_factor_solve_lane_blocked"].items():
        x, l = fn(at, rt)
        _close(x.numpy(), x_lane)
        _close(np.tril(l.numpy()), np.tril(l_lane))
    for kernel in ("chol_solve_batched", "chol_solve_blocked"):
        for label, fn in table[kernel].items():
            _close(fn(at, rt).numpy(), x_solve)
    _close(table["smem_sol"]["probe"](at, rt).numpy(), smem_sol.smem_sol_plain(at).numpy())
    assert layouts.check_variants(at, rt) == {k: 0.0 for k in table}


def test_bounds_at_the_fit_shape():
    """B=8192, n=93, float32: the factor-solve's bytes as chol_factor_solve_lane's
    (all of A read, L and x written), the solves' as chol_solve_lane's (A's
    lower triangle and b read, x written), the probe's one read and one
    write."""
    bnd = layouts.bounds(8192, 93)
    assert {k: v[1] for k, v in bnd.items()} == {k: "bytes" for k in bnd}
    assert round(bnd["chol_factor_solve_lane_blocked"][0], 4) == 0.1710
    assert round(bnd["chol_solve_batched"][0], 4) == round(bnd["chol_solve_blocked"][0], 4) == 0.0446
    assert round(bnd["smem_sol"][0], 3) == 0.169
    assert layouts.default_label("chol_solve_blocked", 93) == "nb=16 block_batch=8"


def test_cpu_calls_do_not_count_launches():
    modules = (chol_lane_blocked, chol_column, chol_blocked, smem_sol)
    for m in modules:
        m.reset_launch_counts()
    a, rhs = _spd_batch(3, 6, seed=2)
    at, rt = torch.from_numpy(a), torch.from_numpy(rhs)
    chol_lane_blocked.chol_factor_solve_lane_blocked(at, rt)
    chol_column.chol_solve_batched(at, rt)
    chol_blocked.chol_solve_blocked(at, rt)
    smem_sol.smem_sol(at)
    assert all(m.LAUNCHES == {m.NAME: 0} for m in modules)


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.eye(93).expand(2, 93, 93).contiguous()
    b = torch.ones(2, 93)
    for name in (chol_lane_blocked.NAME, chol_column.NAME, chol_blocked.NAME):
        with pytest.raises(ValueError, match="CUDA"):
            chol_lane.check_args(name, a, b, dtypes=chol_column.DTYPES)
    with pytest.raises(ValueError, match="CUDA"):
        chol_lane.check_args(smem_sol.NAME, a, dtypes=smem_sol.DTYPES)
    # the probe takes the n chol_factor_lane takes, float32 only: the size
    # and type are refused before the device
    with pytest.raises(ValueError, match="CUDA"):
        chol_lane.check_args(smem_sol.NAME, torch.zeros(1, 268, 268), dtypes=smem_sol.DTYPES)
    with pytest.raises(ValueError, match="lower tiles"):
        chol_lane.check_args(smem_sol.NAME, torch.zeros(1, 269, 269), dtypes=smem_sol.DTYPES)
    with pytest.raises(TypeError):
        chol_lane.check_args(smem_sol.NAME, a.double(), dtypes=smem_sol.DTYPES)
    # chol_solve_batched: one warp per matrix on its padded packed lower
    # triangle, 12 matrices of n = 93 fit one block's shared memory, 13 do
    # not; the default is the TPU kernel's 8. chol_solve_blocked is the same
    # kernel in panels: the same 8, 12 and 13
    assert chol_column.block_batch_for(93) == 8 and chol_column.max_block_batch(93) == 12
    assert chol_column.block_batch_for(37) == 8
    assert (chol_column.smem_bytes(93, 12) <= chol_lane.MAX_SMEM_BYTES
            < chol_column.smem_bytes(93, 13))
    assert chol_blocked.block_batch_for(93) == 8
    assert chol_column.max_block_batch(93, chol_blocked.smem_bytes) == 12
    assert chol_blocked.block_batch_for(37) == 8
    assert (chol_blocked.smem_bytes(93, 12) <= chol_lane.MAX_SMEM_BYTES
            < chol_blocked.smem_bytes(93, 13))
    for fn, refused in ((chol_column.chol_solve_batched, 13), (chol_blocked.chol_solve_blocked, 13)):
        with pytest.raises(ValueError, match="shared memory"):
            fn(a, b, block_batch=refused)
        with pytest.raises(ValueError):
            fn(a, b, block_batch=0)
    with pytest.raises(ValueError):
        chol_blocked.chol_solve_blocked(a, b, nb=0)
    for kb in (0, 33):
        with pytest.raises(ValueError):
            chol_lane_blocked.chol_factor_solve_lane_blocked(a, b, kb=kb)
    # the panel-blocked factor-solve takes chol_factor_solve_lane's n: its
    # shared memory fits one block at every kb, so the tile rule binds
    for kb in range(1, chol_lane_blocked.MAX_PANEL + 1):
        assert chol_lane_blocked.smem_bytes(268, kb) < chol_lane.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="lower tiles"):
        chol_lane.check_args(chol_lane_blocked.NAME, torch.zeros(1, 269, 269),
                             torch.zeros(1, 269),
                             smem=lambda n, dt: chol_lane_blocked.smem_bytes(n, 8),
                             dtypes=chol_lane_blocked.DTYPES)


_LAYOUT_SOURCE = (Path(__file__).resolve().parents[1] / "hybdrt_torch" / "csrc"
                  / "chol_layouts.cu")


def _c_int_expr(expr, **names):
    """Evaluate a C integer expression of the source with Python's integers
    (its divisions are of non-negative ints, so // is C's /)."""
    expr = expr.replace("static_cast<size_t>", "").replace("kTile", "4").replace("/", "//")
    return eval(expr, {}, names)


def test_column_shared_memory_mirrors_the_source():
    """``chol_column.smem_bytes`` is the launcher's: per matrix
    column_matrix_floats(n) floats, 4 (packed_row4(n) + ceil(n / 4)), with
    the row starts of packed_row4 (each row of 4 m + i an odd count of
    16-byte vectors, at least its m + 1), read from csrc/chol_layouts.cu;
    19,152 bytes at n = 93."""
    src = _LAYOUT_SOURCE.read_text()
    row4 = re.search(r"int packed_row4\(int r\) \{\s*const int m = r >> 2;\s*return ([^;]+);",
                     src).group(1)
    floats = re.search(r"int column_matrix_floats\(int n\) \{\s*return ([^;]+);",
                       src).group(1)
    assert ("sizeof(float) * block_batch * static_cast<size_t>(column_matrix_floats(n))"
            in src)
    for r in range(400):
        assert _c_int_expr(row4, r=r, m=r >> 2) == chol_column.packed_row4(r)
        # row r holds its r + 1 values, from a 16-byte boundary
        length = chol_column.packed_row4(r + 1) - chol_column.packed_row4(r)
        assert length % 2 == 1 and 4 * length >= r + 1
    for n in range(1, 400):
        packed = chol_column.packed_row4(n)
        per_matrix = _c_int_expr(floats.replace("packed_row4(n)", str(packed)), n=n)
        for bb in (1, 8, 32):
            assert chol_column.smem_bytes(n, bb) == 4 * bb * per_matrix
    assert chol_column.smem_bytes(93, 1) == 19152


def _parent_column_rule(n, block_batch):
    """The rule chol_solve_batched admitted (n, block_batch) by while it kept
    the whole matrix at row stride n | 1: that matrix and w per warp in one
    block's 232448 bytes."""
    return 4 * block_batch * (n * (n | 1) + n) <= 232448


def _admitted(module, n, block_batch):
    try:
        return module.block_batch_for(n, block_batch) == block_batch
    except ValueError:
        return False


def test_column_admission_takes_every_pair_the_parent_rule_took():
    """Every (n, block_batch) the parent rule took is taken, and more: the
    packed triangle takes n up to 335 at block_batch = 1, against 240."""
    taken = parent = 0
    for n in range(1, 400):
        for bb in range(1, chol_column.MAX_BLOCK_BATCH + 1):
            ok = _admitted(chol_column, n, bb)
            taken += ok
            parent += _parent_column_rule(n, bb)
            if _parent_column_rule(n, bb):
                assert ok, (n, bb)
        assert chol_column.max_block_batch(n) == sum(
            chol_column.smem_bytes(n, bb) <= chol_lane.MAX_SMEM_BYTES
            for bb in range(1, chol_column.MAX_BLOCK_BATCH + 1))
    assert taken > parent
    assert max(n for n in range(1, 400) if chol_column.max_block_batch(n) >= 1) == 335
    assert max(n for n in range(1, 400) if _parent_column_rule(n, 1)) == 240


def test_blocked_shared_memory_mirrors_the_source():
    """chol_solve_blocked's launcher is the column solve's kernel in panels
    (csrc/chol_layouts.cu: launch_blocked_solve calls launch_warp_solve with
    Panels = true, whose shared memory is column_matrix_floats(n) floats a
    matrix), so ``chol_blocked.smem_bytes`` is ``chol_column.smem_bytes``:
    19,152 bytes a matrix at n = 93."""
    src = _LAYOUT_SOURCE.read_text()
    launcher = re.search(r"int launch_blocked_solve\(.*?\n\}", src, re.S).group(0)
    assert "launch_warp_solve<true," in launcher and "launch_warp_solve<false" not in launcher
    warp = re.search(r"int launch_warp_solve\(.*?\n\}", src, re.S).group(0)
    assert ("sizeof(float) * block_batch * static_cast<size_t>(column_matrix_floats(n))"
            in warp)
    for n in range(1, 400):
        for bb in (1, 8, 12, 32):
            assert chol_blocked.smem_bytes(n, bb) == chol_column.smem_bytes(n, bb)
    assert chol_blocked.smem_bytes(93, 1) == 19152


def test_blocked_admission_takes_every_pair_the_parent_rule_took():
    """Every (n, block_batch) the parent rule took (the whole matrix at row
    stride n | 1 and w per warp, the column solve's old rule) is taken now,
    at every n up to the parent's largest (240) and every block_batch; the
    default stays the TPU kernel's 8 wherever the parent's was, and is at
    least the parent's elsewhere (8 against 6 at n = 93)."""
    for n in range(1, 241):
        parent_most = sum(_parent_column_rule(n, bb)
                          for bb in range(1, chol_column.MAX_BLOCK_BATCH + 1))
        for bb in range(1, chol_column.MAX_BLOCK_BATCH + 1):
            if _parent_column_rule(n, bb):
                assert _admitted(chol_blocked, n, bb), (n, bb)
        assert chol_blocked.block_batch_for(n) >= min(8, parent_most)
        assert chol_blocked.block_batch_for(n) == min(8, chol_column.max_block_batch(n))
    assert max(n for n in range(1, 400) if _parent_column_rule(n, 1)) == 240
    assert chol_blocked.block_batch_for(93) == 8 and min(8, sum(
        _parent_column_rule(93, bb) for bb in range(1, 33))) == 6


def test_lane_blocked_shared_memory_mirrors_the_source():
    """``chol_lane_blocked.smem_bytes`` and ``panel_stride`` are the
    launcher's (csrc/chol_layouts.cu): two panel buffers of 4 ceil(n / 4)
    rows at an odd count of 16-byte vectors a row, w, and the upper
    triangle's stage."""
    src = _LAYOUT_SOURCE.read_text()
    stride = re.search(r"int panel_stride\(int kb\) \{\s*return ([^;]+);", src).group(1)
    total = re.search(r"inline size_t kb_smem_bytes\(int n, int kb\) \{\s*"
                      r"const size_t np = ([^;]+);\s*return sizeof\(float\) \* ([^;]+);",
                      src, re.S)
    for kb in range(1, chol_lane_blocked.MAX_PANEL + 1):
        ld = _c_int_expr(stride, kb=kb)
        assert ld == chol_lane_blocked.panel_stride(kb) and ld % 4 == 0 and (ld // 4) % 2 == 1
        assert ld >= kb
        for n in (1, 17, 93, 94, 268):
            np_ = _c_int_expr(total.group(1), n=n)
            body = total.group(2).replace("panel_stride(kb)", str(ld))
            assert chol_lane_blocked.smem_bytes(n, kb) == 4 * _c_int_expr(body, n=n, np=np_)
    assert chol_lane_blocked.panel_stride(4) == 4 and chol_lane_blocked.panel_stride(8) == 12


def _parent_lane_blocked_rule(n):
    """The rule chol_factor_solve_lane_blocked admitted n by while it kept
    the whole matrix in shared memory: that matrix at row stride n | 1, w and
    32 inverse pivots in one block's 232448 bytes, at every kb."""
    return 4 * (n * (n | 1) + n + 32) <= 232448


def test_lane_blocked_admission_takes_every_pair_the_parent_rule_took():
    """Every (n, kb) the parent rule took is taken; now chol_factor_solve_lane's
    tile rule decides, n up to 268 at every kb."""
    for kb in range(1, chol_lane_blocked.MAX_PANEL + 1):
        ns = [n for n in range(1, 400)
              if chol_lane.admitted(n, torch.float32,
                                    smem=lambda n, dt: chol_lane_blocked.smem_bytes(n, kb))]
        assert ns == list(range(1, 269))
        assert all(n in ns for n in range(1, 400) if _parent_lane_blocked_rule(n))
    assert max(n for n in range(1, 400) if _parent_lane_blocked_rule(n)) == 240


@pytest.mark.parametrize("n", [17, 93, 94, 200])
def test_study_variants_include_the_default_and_the_most_that_fit(n):
    """The study times chol_solve_batched at its default block_batch (the TPU
    kernel's 8) and at the most that fit, beside 1, 2, 4 and 6; the blocked
    solve, the same kernel in panels, at nb = 8 and 16, each at 1, 4, 6, the
    same default and the most that fit."""
    table = layouts.variants(n)
    labels = set(table["chol_solve_batched"])
    default, most = chol_column.block_batch_for(n), chol_column.max_block_batch(n)
    assert default == min(8, most)
    assert {f"block_batch={k}" for k in (default, most)} <= labels
    assert {f"block_batch={k}" for k in (1, 2, 4, 6) if k <= most} <= labels
    assert layouts.default_label("chol_solve_batched", n) == f"block_batch={default}"
    bb = chol_blocked.block_batch_for(n)
    assert set(table["chol_solve_blocked"]) == {
        f"nb={nb} block_batch={k}" for nb in (8, 16) for k in {1, 4, 6, bb, most} if k <= most}
    assert layouts.default_label("chol_solve_blocked", n) == f"nb=16 block_batch={bb}"
    if n == 93:
        assert (default, most, bb) == (8, 12, 8)
