"""Coherent multi-observation re-optimization ("resolve").

Counterpart of ``hybdrt_tpu/mapping/resolve.py``. Joint refinement of a
group of neighbouring DRT fits: each observation contributes its posterior
quadratic form (P_i, q_i), and a Gaussian second-derivative smoothing penalty
couples the solutions across the observation (psi) axis. The joint Hessian
H = blockdiag(P_i) + My (x) Cmat is only ever applied, never formed, and the
box QP is solved by a matrix-free Mehrotra interior point whose Newton
systems go through block-Jacobi-preconditioned CG.

Host assembly (``prepare_group_blocks``) is numpy/scipy, as in the JAX
package; the solve runs in torch on ``device``. Where the JAX package vmapped
the solver over windows (``solve_resolve_batch``), the window axis G is
written out: every loop carries one iteration counter and one stop flag per
window, and a window whose loop condition is false keeps its carry, so each
window stops at the interior-point iteration and CG count it stops at in JAX.
``solve_coupled_group`` is the case G = 1. The block-Jacobi factor and its
solves run the lane-Cholesky kernels (``ops/chol_lane.py``:
``chol_factor_lane`` and ``chol_solve_factored_lane``) on a CUDA device.

The reference's own form of a window, one dense QP of the (nr nc, nr nc)
matrix blockdiag(P_i) + My (x) Cmat (``assemble_resolve_system``,
``resolve_observations``), is solved by ``ops/qp.py::solve_qp_box`` at one
lane; at the windows' sizes (7 x 94 = 658 unknowns on the het map) it takes
the QP's library factor route, as the JAX package's unbatched solve takes
LAPACK.
"""
from copy import deepcopy

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d, median_filter

from ..ops import basis as basis_mod
from ..ops.qp import solve_qp_box, spd_factor, spd_solve_factored
from ..utils.device import resolve_device

_MESH_MSG = "mesh: multi-GPU sharding is not ported yet (ROADMAP Queue 1 item 10)"


def get_offset_pq(p, q, special_qp_params, fit_parameters=None, scales=None):
    """P, q with the data-dependent parameters (v_baseline, vz_offset) fixed
    at their fitted values and marginalized into q (resolve.py:21).

    ``fit_parameters`` holds the fitted ``v_baseline`` / ``vz_offset`` and
    ``scales`` the ``response_signal_scale``, ``scaled_response_offset`` and
    ``v_baseline_scale`` of the fit; EIS fits have neither parameter and
    return (p, q) unchanged."""
    remove_names = [k for k in ("v_baseline", "vz_offset") if k in special_qp_params]
    num_remove = int(sum(special_qp_params[k].get("size", 1) for k in remove_names))
    if num_remove == 0:
        return p, q

    x_remove = np.empty(num_remove)
    for k in remove_names:
        v = special_qp_params[k]
        if k == "v_baseline":
            unscaled = np.atleast_1d(fit_parameters["v_baseline"])
            scaled = np.array(unscaled / scales["response_signal_scale"], dtype=float)
            scaled[0] += scales["scaled_response_offset"]
            x_remove[v["index"]:v["index"] + v["size"]] = scaled * scales["v_baseline_scale"]
        else:
            x_remove[v["index"]] = fit_parameters["vz_offset"]

    q_offset = x_remove @ p[:num_remove, num_remove:]
    return p[num_remove:, num_remove:], q[num_remove:] + q_offset


def offset_special_dict(special_qp_params):
    """Special-param dict after removing data-dependent params (resolve.py:49)."""
    shifted = deepcopy(special_qp_params)
    del_index = {name: special_qp_params[name]["index"]
                 for name in ("v_baseline", "vz_offset") if name in special_qp_params}
    if del_index:
        for name in del_index:
            del shifted[name]
        for key in shifted:
            index = shifted[key]["index"]
            shift = sum(special_qp_params[name].get("size", 1)
                        for name, di in del_index.items() if di < index)
            shifted[key]["index"] = index - shift
    return shifted


def resize_pq(p, q, special_offset, tau_indices, match_tau_indices):
    """Pad/truncate the DRT block of (P, q) to a common tau window (resolve.py:66)."""
    num_drt = tau_indices[1] - tau_indices[0]
    match_num = match_tau_indices[1] - match_tau_indices[0]
    new_size = p.shape[0] + (match_num - num_drt)
    left_offset = tau_indices[0] - match_tau_indices[0]
    right_offset = tau_indices[1] - match_tau_indices[1]

    p_out = np.zeros((new_size, new_size))
    q_out = np.zeros(new_size)
    so = special_offset
    p_out[:so, :so] = p[:so, :so]
    q_out[:so] = q[:so]
    p_drt = p[so:, so:]
    q_drt = q[so:]

    if left_offset >= 0 and right_offset <= 0:
        left = so + left_offset
        right = new_size + right_offset if right_offset < 0 else new_size
        p_out[left:right, left:right] = p_drt
        q_out[left:right] = q_drt
        p_out[left:right, :so] = p[so:, :so]
        p_out[:so, left:right] = p[:so, so:]
    elif left_offset < 0 and right_offset > 0:
        p_out[so:, so:] = p_drt[-left_offset:-right_offset, -left_offset:-right_offset]
        q_out[so:] = q_drt[-left_offset:-right_offset]
        p_out[so:, :so] = p[so - left_offset:p.shape[0] - right_offset, :so]
        p_out[:so, so:] = p[:so, so - left_offset:p.shape[0] - right_offset]
    elif left_offset >= 0:
        left = so + left_offset
        p_out[left:, left:] = p_drt[:-right_offset, :-right_offset]
        q_out[left:] = q_drt[:-right_offset]
        p_out[left:, :so] = p[so:p.shape[0] - right_offset, :so]
        p_out[:so, left:] = p[:so, so:p.shape[0] - right_offset]
    else:
        right = new_size + right_offset
        p_out[so:right, so:right] = p_drt[-left_offset:, -left_offset:]
        q_out[so:right] = q_drt[-left_offset:]
        p_out[so:right, :so] = p[so - left_offset:, :so]
        p_out[:so, so:right] = p[:so, so - left_offset:]
    return p_out, q_out


def get_tau_indices(obs_tau_indices, truncate=False):
    if truncate:
        return (int(np.max([t[0] for t in obs_tau_indices])),
                int(np.min([t[1] for t in obs_tau_indices])))
    return (int(np.min([t[0] for t in obs_tau_indices])),
            int(np.max([t[1] for t in obs_tau_indices])))


def prepare_group_blocks(p_list, q_list, coefficient_scale, r_inf_scaled, obs_tau_indices,
                         special_qp_params, nonneg, truncate=False, sigma=1, lambda_psi=1,
                         tau_filter_sigma=0, special_filter_sigma=0, fit_parameters=None,
                         scales=None, x_dop_scaled=None):
    """Per-observation blocks and psi-coupling factors of the joint resolve
    QP (resolve.py:118), without the (nr*nc)^2 block matrix.

    Takes arrays where the JAX function took fitted DRT objects: each
    observation's P and q (``p_list``, ``q_list``), its ``coefficient_scale``,
    its R_inf in scaled units (``r_inf_scaled``, R_inf / coefficient_scale;
    unused without an R_inf column), its (left, right) tau indices on the
    supergrid, the fit's ``special_qp_params`` (one dict for the group, or
    one per observation, as a group of EIS and hybrid fits has; the first
    observation's names the columns) and ``nonneg``. A hybrid observation's
    fitted ``v_baseline`` and ``vz_offset`` are marginalized into its q
    (``get_offset_pq``) from its entry of ``fit_parameters`` and ``scales``
    (lists aligned with ``p_list``). ``truncate`` takes the intersection of
    the observations' tau windows instead of their union. A DOP fit's
    ``x_dop_scaled`` (nr, n_nu), each observation's x_dop / (coefficient
    scale times its DOP scale vector), sets the DOP block's psi penalty
    scale (resolve.py:169-176); ``special_filter_sigma`` smooths the DOP
    block (:178-184).

    Returns (p_stack (nr,nc,nc), q_stack (nr,nc), lb (nc,), my (nr,nr),
    cmat (nc,nc), meta) with meta = (special_dict, match_tau_indices, nr, nc).
    """
    nr = len(p_list)
    sp_list = [special_qp_params] * nr if isinstance(special_qp_params, dict) \
        else list(special_qp_params)
    match_tau_indices = get_tau_indices(obs_tau_indices, truncate=truncate)
    if fit_parameters is None and any(k in sp for sp in sp_list
                                      for k in ("v_baseline", "vz_offset")):
        raise ValueError("v_baseline / vz_offset columns are marginalized at their fitted "
                         "values: give each observation's fit_parameters and scales")
    special_dict = offset_special_dict(sp_list[0])
    if "x_dop" in special_dict and x_dop_scaled is None:
        raise ValueError("a DOP group's psi penalty needs each observation's x_dop_scaled")
    special_offset = int(np.sum([v.get("size", 1) for v in special_dict.values()]))

    p_out, q_out = [], []
    for i in range(nr):
        p, q = get_offset_pq(np.asarray(p_list[i]), np.asarray(q_list[i]), sp_list[i],
                             None if fit_parameters is None else fit_parameters[i],
                             None if scales is None else scales[i])
        p, q = resize_pq(p, q, special_offset, obs_tau_indices[i], match_tau_indices)
        p_out.append(p)
        q_out.append(q)
    nc = len(q_out[0])

    # Second-derivative smoothing stencil across observations
    ly = gaussian_filter1d(np.eye(nr), sigma=sigma, mode="reflect", order=2)
    scale_vec = np.asarray(coefficient_scale, dtype=float)
    scale_smooth = gaussian_filter1d(median_filter(scale_vec, 3), 2)
    lys = ly @ np.diag(scale_vec / scale_smooth)
    my = lys.T @ lys

    # Per-parameter penalty scaling (R_inf and DOP columns)
    param_scale = np.ones(nc)
    if "R_inf" in special_dict:
        ohmic_scale = 5 * np.std(np.asarray(r_inf_scaled, dtype=float))
        if ohmic_scale > 0:
            param_scale[special_dict["R_inf"]["index"]] = ohmic_scale ** -2
    dop_start = dop_end = None
    if "x_dop" in special_dict:
        x_dop = np.asarray(x_dop_scaled, dtype=float)
        dop_scales = np.std(x_dop, axis=0) + 0.1 * np.std(x_dop)
        dop_start = special_dict["x_dop"]["index"]
        dop_end = dop_start + special_dict["x_dop"].get("size", 1)
        param_scale[dop_start:dop_end] = dop_scales ** -2

    # Optional within-observation smoothing filters over the DOP and DRT
    # blocks
    if tau_filter_sigma > 0 or special_filter_sigma > 0:
        filter_mat = np.eye(nc)
        if special_filter_sigma > 0 and dop_start is not None:
            eps = 1 / (np.sqrt(2) * special_filter_sigma)
            filter_mat[dop_start:dop_end, dop_start:dop_end] = \
                basis_mod.construct_func_eval_matrix(
                    np.arange(dop_start, dop_end, dtype=float), epsilon=eps, order=0)
        if tau_filter_sigma > 0:
            eps = 1 / (np.sqrt(2) * tau_filter_sigma)
            filter_mat[special_offset:, special_offset:] = basis_mod.construct_func_eval_matrix(
                np.arange(nc - special_offset, dtype=float), epsilon=eps, order=0)
        cmat = filter_mat @ np.diag(param_scale * lambda_psi) @ filter_mat
    else:
        cmat = np.diag(param_scale * lambda_psi)

    # Lower bounds (identical for every observation)
    lb = np.zeros(nc) if nonneg else np.full(nc, -10.0)
    for sp in special_dict.values():
        if sp["nonneg"]:
            lb[sp["index"]:sp["index"] + sp.get("size", 1)] = 0.0

    return (np.stack(p_out), np.stack(q_out), lb, my, cmat,
            (special_dict, match_tau_indices, nr, nc))


def dense_system(p_stack, q_stack, lb, my, cmat):
    """The dense form of one window's blocks: (P (nr nc, nr nc) =
    blockdiag(P_i) + kron(my, cmat), q (nr nc,), lb (nr nc,))."""
    nr, nc = np.shape(q_stack)
    p_matrix = np.kron(my, cmat)
    for i in range(nr):
        p_matrix[i * nc:(i + 1) * nc, i * nc:(i + 1) * nc] += p_stack[i]
    return p_matrix, np.reshape(q_stack, -1), np.tile(lb, nr)


def assemble_resolve_system(p_list, q_list, coefficient_scale, r_inf_scaled, obs_tau_indices,
                            special_qp_params, nonneg, truncate=False, sigma=1, lambda_psi=1,
                            tau_filter_sigma=0, special_filter_sigma=0, fit_parameters=None,
                            scales=None, x_dop_scaled=None):
    """The joint block QP of one resolve window in dense form (resolve.py:205),
    from the arrays ``prepare_group_blocks`` takes. Returns (p_matrix,
    q_vector, lb, meta) with meta = (special_dict, match_tau_indices, nr, nc)."""
    p_stack, q_stack, lb, my, cmat, meta = prepare_group_blocks(
        p_list, q_list, coefficient_scale, r_inf_scaled, obs_tau_indices, special_qp_params,
        nonneg, truncate=truncate, sigma=sigma, lambda_psi=lambda_psi,
        tau_filter_sigma=tau_filter_sigma, special_filter_sigma=special_filter_sigma,
        fit_parameters=fit_parameters, scales=scales, x_dop_scaled=x_dop_scaled)
    return (*dense_system(p_stack, q_stack, lb, my, cmat), meta)


def solve_dense_window(p_matrix, q_vector, lb, dtype=None, device=None):
    """One window's dense QP through ``solve_qp_box`` at one lane, in
    ``dtype`` (float64 by default) on ``device`` (the card by default), as
    the JAX package solves it (resolve.py:239). Returns (x, IP iterations)."""
    dtype = dtype or torch.float64
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)[None]
    res = solve_qp_box(t(p_matrix), t(q_vector), t(lb))
    return res.x[0].cpu().numpy(), int(res.iterations[0])


def drt_block_inputs(drts):
    """The arrays ``prepare_group_blocks`` takes, read off fitted ``DRT``s as
    the JAX function reads them (resolve.py:21, :153-162): each fit's
    ``fit_parameters`` (P, q, R_inf, the baseline and vz offset), its
    ``coefficient_scale``, the scales of its chrono data, and a DOP or
    capacitance fit's column scales and scaled x_dop. Returns a dict of
    lists."""
    keys = ("response_signal_scale", "scaled_response_offset", "v_baseline_scale")
    out = {k: [] for k in ("p_list", "q_list", "coefficient_scale", "r_inf_scaled",
                           "special_qp_params", "fit_parameters", "scales", "x_dop_scaled",
                           "dop_scale_vector", "capacitance_scale")}
    for drt in drts:
        fp = drt.fit_parameters
        out["p_list"].append(np.asarray(fp["p_matrix"]))
        out["q_list"].append(np.asarray(fp["q_vector"]))
        out["coefficient_scale"].append(drt.coefficient_scale)
        out["r_inf_scaled"].append(fp["R_inf"] / drt.coefficient_scale)
        out["special_qp_params"].append(drt.special_qp_params)
        out["fit_parameters"].append(fp)
        out["scales"].append({k: getattr(drt, k) for k in keys})
        dsv = getattr(drt, "dop_scale_vector", None)
        out["dop_scale_vector"].append(dsv)
        out["capacitance_scale"].append(getattr(drt, "capacitance_scale", None))
        out["x_dop_scaled"].append(None if dsv is None or fp.get("x_dop") is None
                                   else fp["x_dop"] / (drt.coefficient_scale * dsv))
    if any(v is None for v in out["x_dop_scaled"]):
        out["x_dop_scaled"] = None
    return out


def resolve_observations(obs_drt_list, obs_tau_indices, nonneg, obs_psi=None, truncate=False,
                         sigma=1, lambda_psi=1, unpack=False, tau_filter_sigma=0,
                         special_filter_sigma=0, dtype=None, device=None):
    """Jointly re-optimize one window of fitted observations (``DRT``s in
    psi order) with psi smoothing, one dense QP (resolve.py:229). Returns x
    (nr, nc) and the match tau indices, or with ``unpack`` (x_drt,
    x_special, match_tau_indices) in physical units. ``obs_psi`` is taken
    and unused, as in the JAX function. ``dtype`` and ``device`` are the
    solve's (float64 on the card by default)."""
    cols = drt_block_inputs(obs_drt_list)
    p_matrix, q_vector, lb, meta = assemble_resolve_system(
        cols["p_list"], cols["q_list"], cols["coefficient_scale"], cols["r_inf_scaled"],
        obs_tau_indices, cols["special_qp_params"], nonneg, truncate=truncate, sigma=sigma,
        lambda_psi=lambda_psi, tau_filter_sigma=tau_filter_sigma,
        special_filter_sigma=special_filter_sigma, fit_parameters=cols["fit_parameters"],
        scales=cols["scales"], x_dop_scaled=cols["x_dop_scaled"])
    special_dict, match_tau_indices, nr, nc = meta
    x, _ = solve_dense_window(p_matrix, q_vector, lb, dtype=dtype, device=device)
    x_opt = x.reshape((nr, nc))
    if unpack:
        x_drt, x_special = unpack_resolved_x(
            x_opt, cols["coefficient_scale"], special_dict,
            [drt.inductance_scale or 1.0 for drt in obs_drt_list],
            dop_scale_vector=cols["dop_scale_vector"],
            capacitance_scale=cols["capacitance_scale"])
        return x_drt, x_special, match_tau_indices
    return x_opt, match_tau_indices


def pad_windows(blocks):
    """Stack window systems of possibly different widths into (G, w, nc_max,
    ...) host arrays (resolve.py:272-293): narrower windows get pinned
    identity columns with q = 1 and lb = 0, exactly zero in the solution.
    Returns (p_b, q_b, lb_b, my_b, c_b, sizes)."""
    sizes = [q.shape[1] for (_, q, _, _, _) in blocks]
    w = blocks[0][1].shape[0]
    nc_max = max(sizes)
    b = len(blocks)
    p_b = np.zeros((b, w, nc_max, nc_max))
    q_b = np.ones((b, w, nc_max))
    lb_b = np.zeros((b, w, nc_max))
    my_b = np.zeros((b, w, w))
    c_b = np.zeros((b, nc_max, nc_max))
    for i, (p, q, lb, my, cmat) in enumerate(blocks):
        n = q.shape[1]
        p_b[i, :, :n, :n] = p
        if n < nc_max:
            pad_idx = np.arange(n, nc_max)
            p_b[i][:, pad_idx, pad_idx] = 1.0
        q_b[i, :, :n] = q
        lb_b[i, :, :n] = np.broadcast_to(lb, (w, n))
        my_b[i] = my
        c_b[i, :n, :n] = cmat
    return p_b, q_b, lb_b, my_b, c_b, sizes


def solve_resolve_batch(blocks, mesh=None, dtype=None, device=None, tol_gap=1e-12,
                        tol_feas=1e-10, max_iter=60, cg_iters=200, return_info=False):
    """Solve many resolve-window block QPs as one matrix-free computation
    over a window axis (resolve.py:249).

    blocks: list of (p_stack (w, nc_i, nc_i), q_stack (w, nc_i), lb (nc_i,),
    my (w, w), cmat (nc_i, nc_i)) from prepare_group_blocks. ``dtype``
    defaults to float64 and ``device`` to the CUDA card. Returns a list of x
    (w, nc_i) at the original sizes, and with ``return_info`` also a dict of
    the solver's counts (see ``_coupled_body``) with the per-window
    ``n_iter`` and ``kkt_residual``."""
    if mesh is not None:
        raise NotImplementedError(_MESH_MSG)
    *arrays, sizes = pad_windows(blocks)
    x_b, n_iter, kkt, info = _solve(arrays, dtype, device, tol_gap, tol_feas, max_iter,
                                    cg_iters)
    xs = [x_b[i, :, :n] for i, n in enumerate(sizes)]
    if return_info:
        return xs, dict(info, n_iter=n_iter, kkt_residual=kkt)
    return xs


def solve_coupled_group(p_stack, q_stack, lb, my, cmat, mesh=None, dtype=None, device=None,
                        tol_gap=1e-12, tol_feas=1e-10, max_iter=60, cg_iters=200,
                        return_info=False):
    """Solve the whole-group coupled resolve QP as one box-constrained
    problem (resolve.py:321): the exact optimum of the objective the
    overlapping windows only approximate. ``dtype`` defaults to float64 and
    ``device`` to the CUDA card.

    Returns (x (nr, nc), n_iter, kkt_residual), and with ``return_info`` a
    dict of the solver's counts (see ``_coupled_body``) as a fourth item."""
    if mesh is not None:
        raise NotImplementedError(_MESH_MSG)
    nr, nc = np.shape(q_stack)
    arrays = [np.asarray(p_stack)[None], np.asarray(q_stack)[None],
              np.broadcast_to(np.asarray(lb), (1, nr, nc)), np.asarray(my)[None],
              np.asarray(cmat)[None]]
    x, n_iter, kkt, info = _solve(arrays, dtype, device, tol_gap, tol_feas, max_iter,
                                  cg_iters)
    out = (x[0], int(n_iter[0]), float(kkt[0]))
    return out + (info,) if return_info else out


def _solve(arrays, dtype, device, tol_gap, tol_feas, max_iter, cg_iters):
    dtype = dtype or torch.float64
    device = resolve_device(device)
    p, q, lb, my, cmat = (torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
                          for a in arrays)
    x, n_iter, kkt, info = _coupled_body(p, q, lb, my, cmat, tol_gap, tol_feas, max_iter,
                                         cg_iters)
    return x.cpu().numpy(), n_iter.cpu().numpy(), kkt.cpu().numpy(), info


def _coupled_body(p, q, lb, my, cmat, tol_gap, tol_feas, max_iter, cg_iters):
    """Matrix-free Mehrotra predictor-corrector for G independent windows,
    min 1/2 sum_i x_i P_i x_i + q.x + 1/2 psi-coupling, s.t. x >= lb
    (resolve.py:381): Jacobi equilibration, the sigma heuristic, the step
    rule min(1, 0.99 ratio) with ratio capped at 1e20, the whole-window
    freeze on a non-finite step and three active-set polish rounds, each
    Newton system solved by block-Jacobi-preconditioned CG.

    p (G, w, nc, nc), q and lb (G, w, nc), my (G, w, w), cmat (G, nc, nc).
    Returns (x (G, w, nc) in original units, n_iter (G,), kkt (G,), info),
    info counting the window-PCG solves (``pcg_solves``), their CG
    iterations (``cg_iterations``) and the host syncs of the loop conditions
    (``host_syncs``)."""
    dt, dev = q.dtype, q.device
    g_n, w, nc = q.shape
    n = w * nc
    c = lambda v: torch.tensor(v, dtype=dt, device=dev)
    eps = torch.finfo(dt).eps
    tol_gap = torch.clamp(c(tol_gap), min=50 * eps)
    tol_feas = torch.clamp(c(tol_feas), min=50 * eps)
    cg_rtol = c(100.0) * eps
    # Python-float floors become dt on use: 1e-300 is 0 in float32, as in JAX
    floor = 1e-300
    tiny = c(1e-30 if dt == torch.float64 else 1e-25)
    # Counts for solve_info: tensors summed on the device (no sync), and the
    # host syncs of the loop conditions
    solves = torch.zeros((), dtype=torch.int64, device=dev)
    cg_steps = torch.zeros((), dtype=torch.int64, device=dev)
    syncs = 0

    def win(t):
        """Per-window scalar (G,) -> broadcastable against (G, w, nc)."""
        return t[:, None, None]

    def vdot(a, b):
        return torch.sum(a * b, dim=(-2, -1))

    def amax(a):
        return torch.amax(a, dim=(-2, -1))

    def every(m):
        return torch.all(m.reshape(g_n, -1), dim=-1)

    myd = torch.diagonal(my, dim1=-2, dim2=-1)
    cdiag = torch.diagonal(cmat, dim1=-2, dim2=-1)

    # Jacobi equilibration (exact reparameterization x = dvec * x~)
    hdiag = torch.diagonal(p, dim1=-2, dim2=-1) + myd[:, :, None] * cdiag[:, None, :]
    dvec = 1.0 / torch.sqrt(torch.clamp(hdiag, min=floor))
    q_e = q * dvec
    lb_e = lb / dvec
    q_scale = 1.0 + amax(torch.abs(q_e))
    # Equilibrated diagonal blocks (exact), used by the preconditioner only
    mj = dvec[..., :, None] * (p + myd[:, :, None, None] * cmat[:, None]) * dvec[..., None, :]

    def hv_e(v):
        u = dvec * v
        return dvec * (torch.matmul(p, u[..., None])[..., 0] + (my @ u) @ cmat)

    def factor(a):
        # one contiguous (G*w, nc, nc) batch per launch
        return spd_factor(a.reshape(g_n * w, nc, nc))

    def solver(lfac):
        return lambda r: spd_solve_factored(lfac, r.reshape(g_n * w, nc)).reshape(g_n, w, nc)

    def pcg(apply, prec, b, active):
        """Preconditioned CG per window, fixed relative tolerance, capped
        iterations; windows not ``active`` keep x = 0 and take no step."""
        nonlocal solves, cg_steps, syncs
        x = torch.zeros_like(b)
        r = b
        z = prec(r)
        pd = z
        rz = vdot(r, z)
        k = torch.zeros(g_n, dtype=torch.int32, device=dev)
        stop2 = (cg_rtol ** 2) * vdot(b, b)
        while True:
            live = (vdot(r, r) > stop2) & (k < cg_iters) & active
            syncs += 1
            if not bool(live.any()):
                break
            hp = apply(pd)
            den = vdot(pd, hp)
            alpha = win(torch.where(den > 0, rz / den, 0.0))
            x_n = x + alpha * pd
            r_n = r - alpha * hp
            z_n = prec(r_n)
            rz_n = vdot(r_n, z_n)
            beta = win(torch.where(rz > 0, rz_n / rz, 0.0))
            pd_n = z_n + beta * pd
            lv = win(live)
            x, r, z, pd = (torch.where(lv, new, old) for new, old in
                           ((x_n, x), (r_n, r), (z_n, z), (pd_n, pd)))
            rz = torch.where(live, rz_n, rz)
            k = k + live.to(torch.int32)
        solves = solves + active.sum()
        cg_steps = cg_steps + k.sum()
        return x

    def max_step(v, dv):
        m = dv < 0
        ratio = torch.where(m, -v / torch.where(m, dv, -1.0), torch.inf)
        return torch.clamp(torch.amin(ratio, dim=(-2, -1)), max=1e20)

    # --- Initialization: block-Jacobi unconstrained solve pushed interior
    x0 = solver(factor(mj))(-q_e)
    s0 = torch.clamp(x0 - lb_e, min=1.0)
    x0 = lb_e + s0
    z0 = torch.clamp(torch.abs(hv_e(x0) + q_e), min=1.0)

    def converged(x, s, z):
        hx = hv_e(x)
        r_d = hx + q_e - z
        gap = vdot(s, z) / n
        obj = 0.5 * vdot(x, hx) + vdot(q_e, x)
        ok_gap = gap <= tol_gap * (1.0 + torch.abs(obj))
        ok_dual = amax(torch.abs(r_d)) <= tol_feas * q_scale
        return ok_gap & ok_dual

    x, s, z = x0, s0, z0
    it = torch.zeros(g_n, dtype=torch.int32, device=dev)
    done = torch.zeros(g_n, dtype=torch.bool, device=dev)
    while True:
        # Per-window loop condition of the vmapped while_loop; a window that
        # fails it keeps its carry (one host sync per interior-point step)
        live = (it < max_iter) & ~done
        syncs += 1
        if not bool(live.any()):
            break
        d = z / s
        r_d = hv_e(x) + q_e - z
        r_p = s - (x - lb_e)

        # Barrier-augmented block-Jacobi preconditioner, re-factored per step
        prec = solver(factor(mj + torch.diag_embed(d)))

        def apply(v):
            return hv_e(v) + d * v

        mu = vdot(s, z) / n
        rhs_aff = -r_d - z + d * r_p
        dx_aff = pcg(apply, prec, rhs_aff, live)
        ds_aff = dx_aff - r_p
        dz_aff = -z - d * ds_aff
        a_p = win(torch.clamp(max_step(s, ds_aff), max=1.0))
        a_d = win(torch.clamp(max_step(z, dz_aff), max=1.0))
        mu_aff = vdot(s + a_p * ds_aff, z + a_d * dz_aff) / n
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=floor)) ** 3, 0.0, 1.0)

        r_c = s * z + ds_aff * dz_aff - win(sigma * mu)
        rhs = -r_d - r_c / s + d * r_p
        dx = pcg(apply, prec, rhs, live)
        ds = dx - r_p
        dz = -r_c / s - d * ds

        a_p = win(torch.clamp(0.99 * max_step(s, ds), max=1.0))
        a_d = win(torch.clamp(0.99 * max_step(z, dz), max=1.0))
        x_n = x + a_p * dx
        s_n = torch.clamp(s + a_p * ds, min=tiny)
        z_n = torch.clamp(z + a_d * dz, min=tiny)
        bad = ~(every(torch.isfinite(x_n)) & every(torch.isfinite(z_n)))
        keep = win(done | bad)
        x_n = torch.where(keep, x, x_n)
        s_n = torch.where(keep, s, s_n)
        z_n = torch.where(keep, z, z_n)
        done_n = done | bad | converged(x_n, s_n, z_n)

        lv = win(live)
        x = torch.where(lv, x_n, x)
        s = torch.where(lv, s_n, s)
        z = torch.where(lv, z_n, z)
        done = torch.where(live, done_n, done)
        it = it + live.to(torch.int32)

    # --- Active-set polish (equilibrated diag(H) == 1, so activity is s < z),
    # three rounds, each keeping the last valid polished point (resolve.py:517)
    active = s < z
    all_windows = torch.ones(g_n, dtype=torch.bool, device=dev)
    for _ in range(3):
        fm = (~active).to(dt)

        def apply_pol(v, fm=fm):
            return fm * hv_e(fm * v) + (1.0 - fm) * v

        # the factor takes a masked copy; mj itself stays as it is
        prec_pol = solver(factor(fm[..., :, None] * mj * fm[..., None, :]
                                 + torch.diag_embed(1.0 - fm)))
        rhs_pol = torch.where(active, lb_e, -q_e - hv_e(torch.where(active, lb_e, 0.0)))
        x_pol = pcg(apply_pol, prec_pol, rhs_pol, all_windows)
        x_pol = torch.where(active, lb_e, x_pol)
        grad = hv_e(x_pol) + q_e
        z_pol = torch.where(active, grad, 0.0)
        valid = (every(x_pol >= lb_e - 1e-9 * (1 + torch.abs(lb_e)))
                 & every(z_pol >= -win(tol_feas * q_scale)))
        x = torch.where(win(valid), x_pol, x)
        active = (active & (z_pol >= 0)) | (x_pol < lb_e)

    # --- Report in original units
    x_out = dvec * x
    g = torch.matmul(p, x_out[..., None])[..., 0] + (my @ x_out) @ cmat + q
    at_b = x_out <= lb + torch.sqrt(c(eps)) * (1.0 + torch.abs(lb))
    kkt = amax(torch.abs(torch.where(at_b, torch.clamp(g, max=0.0), g)))
    info = {"pcg_solves": int(solves), "cg_iterations": int(cg_steps), "host_syncs": syncs}
    return x_out, it, kkt, info


def unpack_resolved_x(x, coefficient_scale, special_dict, inductance_scale=1.0,
                      dop_scale_vector=None, capacitance_scale=None):
    """Rescale resolved coefficients to physical units (resolve.py:563);
    ``inductance_scale`` and ``capacitance_scale`` are one for the group or
    one per observation, ``dop_scale_vector`` (n_nu,) for the group or one
    per observation (nr, n_nu). Returns (x_drt (nr, n_tau), {name: (nr,) or
    (nr, size)})."""
    special_offset = int(np.sum([v.get("size", 1) for v in special_dict.values()]))
    coef_scale = np.asarray(coefficient_scale, dtype=float)
    x_drt = x[:, special_offset:] * coef_scale[:, None]

    x_special = {}
    for key, info in special_dict.items():
        if key == "x_dop" and dop_scale_vector is None:
            raise ValueError("x_dop: give the fits' dop_scale_vector")
        if key == "C_inv" and capacitance_scale is None:
            raise ValueError("C_inv: give the fits' capacitance_scale")
        start, size = info["index"], info.get("size", 1)
        x_k = x[:, start:start + size] * coef_scale[:, None]
        if key == "x_dop":
            x_k = x_k * np.asarray(dop_scale_vector, dtype=float)
        elif key == "C_inv":
            x_k = x_k * np.reshape(np.asarray(capacitance_scale, dtype=float), (-1, 1))
        elif key == "inductance":
            x_k = x_k * np.reshape(np.asarray(inductance_scale, dtype=float), (-1, 1))
        if size == 1:
            x_k = x_k.flatten()
        x_special[key] = x_k
    return x_drt, x_special
