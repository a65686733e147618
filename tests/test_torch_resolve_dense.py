"""Port parity: the reference's default group resolve, one dense QP a window
(hybdrt_torch/mapping/drtmd.py::DRTMD.resolve_group's default and
``resolve_observations``, mapping/resolve.py::assemble_resolve_system and
``resolve_observations``, the free ``resolve_group(batched=False)``), against
hybdrt_tpu on the CPU, float64.

Each window is ``solve_qp_box`` at one lane, which at these sizes (7 x nc
unknowns, nc = 93) takes the QP's library factor route. Held: the resolved
coefficients and special parameters within rtol 1e-8, atol 1e-10 of the JAX
package's, and each window's interior-point iterations equal to the JAX
dense solve's (its ``solve_qp_box`` on its own assembled window). The dense
path against the port's ``batched=True``: within the same bound on the
tests/test_mapping.py map, as the JAX package holds its own
(tests/test_mapping.py:307-316). On the mixed map (hybrid observations) the
two forms stop at different points of a flat optimum, in both packages
alike (ROADMAP Queue 3 item 16): there the port's difference between them
is held to the JAX package's, and their objectives to 1e-12 of |f|.
"""
import copy

import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping import resolve as jax_resolve
from hybdrt_tpu.ops.qp import solve_qp_box as jax_solve_qp_box
from hybdrt_torch.mapping import resolve
from hybdrt_torch.mapping.drtmd import DRTMD, resolve_group, resolve_windows
from hybdrt_torch.ops import chol_lane
from hybdrt_torch.parallel.batch import BatchedEISFitter
from hybdrt_torch.utils import probe

import serial_maps

torch.set_num_threads(1)

RTOL, ATOL = 1e-8, 1e-10


def _pair(kind, batched=False):
    mj, mt = serial_maps.pair(kind)
    mj.fit_all(batched=batched)
    mt.fit_all(batched=batched)
    return mj, mt


@pytest.fixture(scope="module")
def maps():
    out = {kind: _pair(kind) for kind in ("ten", "mixed")}
    out["eis-batched"] = _pair("eis", batched=True)
    return out


def _resolved(md, **kw):
    md = copy.deepcopy(md)
    md.resolve_group("g", psi_sort_dims=["T"], **kw)
    return md


def _jax_window_iterations(mj):
    """The JAX dense path's IP iterations, window by window: its own
    assembly of each window and its solve_qp_box."""
    obs = mj.get_group_index("g")
    obs = obs[np.lexsort([mj.obs_psi[obs, 0]])]
    out = []
    for start, end in resolve_windows(len(obs), 7, 2):
        fits = mj.get_fits_batched(obs[start:end])
        drts = [fits[i] for i in obs[start:end]]
        p, q, lb, _ = jax_resolve.assemble_resolve_system(
            drts, [mj.obs_tau_indices[i] for i in obs[start:end]], True)
        out.append(int(jax_solve_qp_box(p, q, lb).iterations))
    return np.array(out)


@pytest.mark.parametrize("kind", ["ten", "mixed", "eis-batched"])
def test_default_resolve_matches_jax(maps, kind):
    mj, mt = maps[kind]
    rj = _resolved(mj)
    chol_lane.reset_launch_counts()
    rt = _resolved(mt)
    info = rt.resolve_info
    assert info["dense"] and not info["coupled"]
    assert rt.obs_resolve_status.all()
    np.testing.assert_allclose(rt.obs_x_resolved, rj.obs_x_resolved, rtol=RTOL, atol=ATOL)
    for key in rj.obs_special_resolved:
        np.testing.assert_allclose(rt.obs_special_resolved[key], rj.obs_special_resolved[key],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(info["n_iter"], _jax_window_iterations(mj))
    # every window's QP took the library route
    assert chol_lane.QP_ROUTES == {"lane": 0, "library": info["windows"]}
    assert info["windows"] == len(resolve_windows(mt.num_obs, 7, 2))


def test_dense_matches_batched(maps):
    """tests/test_mapping.py:307-316 through the port: the windows solved
    together, matrix-free, against the dense windows."""
    _, mt = maps["ten"]
    dense, batch = _resolved(mt), _resolved(mt, batched=True)
    np.testing.assert_allclose(batch.obs_x_resolved, dense.obs_x_resolved, rtol=RTOL, atol=ATOL)
    for key in dense.obs_special_resolved:
        np.testing.assert_allclose(batch.obs_special_resolved[key],
                                   dense.obs_special_resolved[key], rtol=RTOL, atol=ATOL)


def test_dense_and_batched_differ_as_in_jax(maps):
    """The mixed map: dense and batched windows land at different points of
    a flat optimum in both packages; the port's gap is the JAX package's,
    and the two objectives agree to 1e-12 of |f| (Queue 3 item 16)."""
    mj, mt = maps["mixed"]
    gap_j = _resolved(mj, batched=True).obs_x_resolved - _resolved(mj).obs_x_resolved
    dense, batch = _resolved(mt), _resolved(mt, batched=True)
    gap_t = batch.obs_x_resolved - dense.obs_x_resolved
    scale = np.max(np.abs(dense.obs_x_resolved))
    assert np.max(np.abs(gap_t - gap_j)) <= 1e-6 * scale
    f_dense = dense.group_objective("g", psi_sort_dims=["T"])
    f_batch = batch.group_objective("g", psi_sort_dims=["T"])
    assert abs(f_dense - f_batch) <= 1e-12 * abs(f_dense)


def test_resolve_observations_one_window(maps):
    """DRTMD.resolve_observations on the first seven observations, and
    resolve.resolve_observations on their DRTs, against the JAX package's."""
    mj, mt = maps["mixed"]
    idx = np.arange(7)
    rj, rt = copy.deepcopy(mj), copy.deepcopy(mt)
    rj.resolve_observations(idx, psi_sort_dims=["T"])
    rt.resolve_observations(idx, psi_sort_dims=["T"])
    np.testing.assert_allclose(rt.obs_x_resolved, rj.obs_x_resolved, rtol=RTOL, atol=ATOL)
    assert rt.obs_resolve_status[:7].all() and not rt.obs_resolve_status[7:].any()
    fits_t, fits_j = mt.get_fits_batched(idx), mj.get_fits_batched(idx)
    tau_idx = [mt.obs_tau_indices[i] for i in idx]
    xt, st, mti = resolve.resolve_observations([fits_t[i] for i in idx], tau_idx, True,
                                               unpack=True, device="cpu")
    xj, sj, mtj = jax_resolve.resolve_observations([fits_j[i] for i in idx], tau_idx, True,
                                                   unpack=True)
    assert tuple(mti) == tuple(mtj)
    np.testing.assert_allclose(xt, xj, rtol=RTOL, atol=ATOL)
    for key in sj:
        np.testing.assert_allclose(st[key], sj[key], rtol=RTOL, atol=ATOL)
    x_raw, _ = resolve.resolve_observations([fits_t[i] for i in idx], tau_idx, True,
                                            device="cpu")
    assert x_raw.shape == (7, xt.shape[1] + 2)  # R_inf and inductance first


def test_assemble_resolve_system(maps):
    """The dense window system against the JAX package's assembly on the
    same fits (the JAX DRTs' arrays, read by ``drt_block_inputs``)."""
    mj, mt = maps["mixed"]
    idx = np.arange(1, 8)
    fits_j = mj.get_fits_batched(idx)
    tau_idx = [mt.obs_tau_indices[i] for i in idx]
    cols = resolve.drt_block_inputs([fits_j[i] for i in idx])
    p_t, q_t, lb_t, meta_t = resolve.assemble_resolve_system(
        cols["p_list"], cols["q_list"], cols["coefficient_scale"], cols["r_inf_scaled"],
        tau_idx, cols["special_qp_params"], True, fit_parameters=cols["fit_parameters"],
        scales=cols["scales"])
    p_j, q_j, lb_j, meta_j = jax_resolve.assemble_resolve_system(
        [fits_j[i] for i in idx], tau_idx, True)
    assert meta_t[1:] == tuple(meta_j[1:])
    np.testing.assert_allclose(p_t, p_j, rtol=1e-12, atol=1e-12 * np.max(np.abs(p_j)))
    np.testing.assert_allclose(q_t, q_j, rtol=1e-12, atol=1e-12 * np.max(np.abs(q_j)))
    np.testing.assert_array_equal(lb_t, lb_j)


def test_lone_and_empty_windows(maps):
    _, mt = maps["ten"]
    md = copy.deepcopy(mt)
    md.resolve_observations([4])
    np.testing.assert_array_equal(md.obs_x_resolved[4], md.obs_x[4])
    with pytest.warns(UserWarning, match="No valid observations"):
        md.resolve_observations(np.array([], dtype=int))


def test_free_resolve_group_dense():
    """The free resolve_group(batched=False) on a BatchedEISFitter's map:
    against its batched=True form and against DRTMD's default resolve of
    the same map fitted batched, which stores the same fit."""
    tau, obs = probe.small_map("eis")
    freq = obs[0][2][0]
    zs = np.stack([e[1] for _, _, e in obs])
    psis = np.array([p[0] for p, _, _ in obs])
    fitter = BatchedEISFitter(freq, tau_supergrid=tau, dtype=torch.float64, device="cpu")
    res = fitter.fit(zs)
    dense = resolve_group(fitter, res, zs, psi=psis, batched=False, device="cpu")
    batch = resolve_group(fitter, res, zs, psi=psis, device="cpu")
    assert dense.info["dense"] and len(dense.info["n_iter"]) == dense.info["windows"]
    np.testing.assert_allclose(dense.x, batch.x, rtol=RTOL, atol=ATOL)
    md = DRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, device="cpu")
    for psi, c, e in obs:
        md.add_observation(psi, c, e, group_id="g")
    md.fit_all(batched=True)
    md.resolve_group("g", psi_sort_dims=["T"])
    li, ri = dense.tau_indices
    np.testing.assert_allclose(md.obs_x_resolved[:, li:ri], dense.x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(md.obs_special_resolved["R_inf"], dense.special["R_inf"],
                               rtol=RTOL, atol=ATOL)


def test_remaining_raises(maps):
    _, mt = maps["ten"]
    with pytest.raises(NotImplementedError, match=r"item 10(?!\d)"):
        mt.resolve_group("g", mesh=object())
    with pytest.raises(NotImplementedError, match=r"item 10(?!\d)"):
        mt.fit_all(mesh=object())
