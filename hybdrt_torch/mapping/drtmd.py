"""Group resolve of a uniform EIS map (counterpart of the uniform-group body
of ``hybdrt_tpu/mapping/drtmd.py::DRTMD.resolve_group``, ``:1427-1585``).

A map fitted by one ``BatchedEISFitter`` on one frequency grid with a
``tau_supergrid`` (what ``DRTMD.fit_all(batched=True)`` does for a uniform
EIS group) is re-optimized jointly: each observation's posterior (P, q) is
rebuilt from its final fit state, the observations are sorted by psi, and
either the whole group is solved as one coupled QP (``coupled=True``) or
overlapping windows of ``batch_size`` are solved together and averaged over
their overlaps (``batched=True``). The ``DRTMD`` class itself is not ported
yet (ROADMAP Queue 1 item 7); its ``resolve_group`` will call this.
"""
import warnings
from typing import NamedTuple

import numpy as np
import torch

from . import resolve as resolve_mod


class GroupResolveResult(NamedTuple):
    """Resolved parameters in the order of the fit's batch."""
    x: np.ndarray         # (nr, right - left) DRT coefficients on the supergrid window
    special: dict         # name -> (nr,): R_inf, inductance
    tau_indices: tuple    # (left, right) of the window on the fitter's tau_supergrid
    order: np.ndarray     # (nr,) the psi order the observations were resolved in
    info: dict            # resolve_info, and the solver's counts


def uniform_pq(fitter, result, z_batch):
    """Each observation's posterior (P, q) at its final fit state: the
    weighted QP of the last outer iteration, rebuilt in float64 on the
    fitter's device from ``result`` (rho, s_vectors, weights, scale; device
    tensors with ``collect="lazy"``) and the spectra (drtmd.py:1036). Returns
    host float64 (B, N, N), (B, N)."""
    p, q, _ = fitter._posterior(result, z_batch)
    return p.cpu().numpy(), q.cpu().numpy()


def psi_order(psi):
    """Sort order of the observations by psi, the first column the primary
    key (drtmd.py:1431-1435); psi (nr,) or (nr, n_dims)."""
    psi = np.asarray(psi, dtype=float)
    cols = psi[:, None] if psi.ndim == 1 else psi
    return np.lexsort(cols.T[::-1])


def resolve_windows(num_obs, batch_size, overlap):
    """(start, end) of each overlapping window (drtmd.py:1483-1493)."""
    batch_size = min(batch_size, num_obs)
    step = max(batch_size - overlap, 1)
    windows = []
    for start in range(0, num_obs, step):
        if num_obs - start < batch_size:
            start = max(0, num_obs - batch_size)
        windows.append((start, start + batch_size))
        if start + batch_size >= num_obs:
            break
    return windows


def group_objective(fitter, result, z_batch, psi, out):
    """The coupled group objective 1/2 x.Hx + q.x (host float64, solver
    units) of the psi-sorted group at the resolved solution ``out`` of
    ``resolve_group`` (default assembly options), as
    tests/test_resolve_coupled.py:135 evaluates it: the coupled resolve
    minimizes it, so it is no higher there than at the windowed resolve."""
    p_all, q_all = uniform_pq(fitter, result, z_batch)
    order = psi_order(psi)
    scale = np.asarray(result.scale, dtype=float)[order]
    r_inf_scaled = (np.asarray(result.r_inf, dtype=float) / np.asarray(result.scale))[order]
    p, q, _, my, cmat, (special, _, _, _) = resolve_mod.prepare_group_blocks(
        p_all[order], q_all[order], scale, r_inf_scaled, [fitter.tau_indices] * len(order),
        fitter.special_qp_params, True)
    x = np.zeros(q.shape)
    x[:, len(special):] = out.x[order] / scale[:, None]
    for key, info in special.items():
        unit = fitter.inductance_scale if key == "inductance" else 1.0
        x[:, info["index"]] = out.special[key][order] / (scale * unit)
    hx = np.einsum("bij,bj->bi", p, x) + (my @ x) @ cmat
    return float(0.5 * np.vdot(x, hx) + np.vdot(q, x))


def resolve_group(fitter, result, z_batch, psi=None, coupled=False, batched=True,
                  batch_size=7, overlap=2, sigma=1, lambda_psi=1, tau_filter_sigma=0,
                  dtype=None, device=None):
    """Jointly re-optimize the spectra ``z_batch`` (B, n_freq) that ``fitter``
    (built with a ``tau_supergrid``) fitted into ``result``.

    ``psi`` (B,) or (B, n_dims) orders the observations (first column
    first); without it they keep the batch's order. ``coupled=True`` solves
    the whole group as one QP (``resolve.solve_coupled_group``) and reports
    its KKT residual against a tolerance, with a warning above it;
    otherwise the windows of ``batch_size`` overlapping by ``overlap`` are
    solved together (``resolve.solve_resolve_batch``) and averaged with the
    reference's margin weights. ``dtype`` (default float64) is the solve's;
    the solve runs on the CUDA card unless ``device="cpu"``.
    """
    if fitter.tau_indices is None:
        raise ValueError("the fitter has no tau_supergrid: build it with "
                         "BatchedEISFitter(..., tau_supergrid=...)")
    if not coupled and not batched:
        raise NotImplementedError(
            "batched=False (the dense per-window solve): its (batch_size*nc)^2 systems do "
            "not fit one block's shared memory in the lane-Cholesky kernels, and it needs a "
            "library factor, as the JAX package's unbatched path reaches no Pallas kernel "
            "(ROADMAP Queue 1 item 8). Use batched=True or coupled=True")
    x_fit = np.asarray(result.x)
    if not (np.all(np.isfinite(x_fit)) and np.all(np.isfinite(result.r_inf))):
        bad = np.flatnonzero(~(np.isfinite(x_fit).all(axis=1) & np.isfinite(result.r_inf)))
        raise ValueError(f"Batched fit produced non-finite coefficients at {bad.tolist()}")
    num_obs = len(x_fit)
    order = np.arange(num_obs) if psi is None else psi_order(psi)

    p_all, q_all = uniform_pq(fitter, result, z_batch)
    scale = np.asarray(result.scale, dtype=float)
    r_inf_scaled = np.asarray(result.r_inf, dtype=float) / scale
    tau_indices = tuple(fitter.tau_indices)
    nonneg = bool(np.all(np.asarray(fitter.lb.cpu())[fitter.num_special:] >= 0))

    def blocks(idx):
        return resolve_mod.prepare_group_blocks(
            p_all[idx], q_all[idx], scale[idx], r_inf_scaled[idx], [tau_indices] * len(idx),
            fitter.special_qp_params, nonneg, sigma=sigma, lambda_psi=lambda_psi,
            tau_filter_sigma=tau_filter_sigma)

    def unpack(x, idx, special_dict):
        return resolve_mod.unpack_resolved_x(x, scale[idx], special_dict,
                                             fitter.inductance_scale)

    solve_kw = dict(dtype=dtype, device=device, return_info=True)
    if coupled and num_obs > 1:
        p_stack, q_stack, lb, my, cmat, (special_dict, _, _, _) = blocks(order)
        x, n_iter, kkt, counts = resolve_mod.solve_coupled_group(p_stack, q_stack, lb, my,
                                                                 cmat, **solve_kw)
        # Calibrated in the JAX package: relative KKT ~1e-14 (f64) / ~1e-5
        # (f32) on representative systems, so 2+ orders of headroom
        kkt_scale = max(1.0, float(np.abs(q_stack).max()))
        kkt_tol = (1e-3 if dtype == torch.float32 else 1e-6) * kkt_scale
        info = {"coupled": True, "n_iter": n_iter, "kkt_residual": kkt, "kkt_tol": kkt_tol,
                **counts}
        if not np.isfinite(kkt) or kkt > kkt_tol:
            warnings.warn(
                f"Coupled group resolve did not fully converge (KKT residual {kkt:.3g} > "
                f"{kkt_tol:.3g} after {n_iter} IP iterations); the resolved distributions "
                f"may be inaccurate. Consider dtype=float64 or the windowed resolve "
                f"(coupled=False).")
        x_drt, x_sp = unpack(x, order, special_dict)
        x_out = np.zeros_like(x_drt)
        x_out[order] = x_drt
        special = {}
        for key, val in x_sp.items():
            special[key] = np.zeros_like(val)
            special[key][order] = val
        return GroupResolveResult(x_out, special, tau_indices, order, info)

    # Windowed: every window's block QP solved together. A single observation
    # is one window of one (the JAX package takes its dense solve there; the
    # QP is the same)
    windows = resolve_windows(num_obs, batch_size, overlap)
    batch_size = windows[0][1] - windows[0][0]
    systems, metas = [], []
    for start, end in windows:
        p_stack, q_stack, lb, my, cmat, meta = blocks(order[start:end])
        systems.append((p_stack, q_stack, lb, my, cmat))
        metas.append(meta)
    xs, info = resolve_mod.solve_resolve_batch(systems, **solve_kw)
    info = {"coupled": False, "windows": len(windows), **info}

    n_cols = tau_indices[1] - tau_indices[0]
    x_batch = np.zeros((len(windows), num_obs, n_cols))
    sp_batch = {}
    margins = np.full((len(windows), num_obs), -1.0)
    x_res = np.zeros((num_obs, n_cols))
    sp_res = {}
    for i, (x_win, (special_dict, _, _, _)) in enumerate(zip(xs, metas)):
        start, end = windows[i]
        bidx = order[start:end]
        x_drt, x_sp = unpack(np.asarray(x_win), bidx, special_dict)
        # later windows overwrite earlier ones where nothing is averaged
        x_res[bidx] = x_drt
        x_batch[i, start:end] = x_drt
        for key, val in x_sp.items():
            sp_res.setdefault(key, np.zeros((num_obs, *val.shape[1:])))[bidx] = val
            sp_batch.setdefault(key, np.zeros((len(windows), num_obs, *val.shape[1:])))
            sp_batch[key][i, start:end] = val
        margins[i, start:end] = np.minimum(np.arange(batch_size), np.arange(batch_size)[::-1])

    # Overlap averaging with the reference's margin weights (drtmd.py:1573),
    # in psi order; results go back to the batch's order
    if overlap > 0 and num_obs > 1:
        weights = margins + 0.1
        weights[weights < 0] = 0
        x_sorted = np.average(x_batch, axis=0,
                              weights=np.broadcast_to(weights[..., None], x_batch.shape))
        x_res[order] = x_sorted
        for key, val in sp_batch.items():
            w_k = weights if val.ndim == 2 else np.broadcast_to(weights[..., None], val.shape)
            sp_res[key][order] = np.average(val, axis=0, weights=w_k)
    return GroupResolveResult(x_res, sp_res, tau_indices, order, info)
