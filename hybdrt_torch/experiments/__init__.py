"""The Cholesky layout study: the port's counterpart of the repository's
``experiments/`` directory.

Four kernels, hand-written CUDA in ``hybdrt_torch/csrc/chol_layouts.cu``,
each computing the function of a production lane kernel
(``hybdrt_torch/ops/chol_lane.py``) in another layout:

- ``chol_lane_blocked``: the panel-blocked factor and solve
  (``experiments/pallas_chol_lane_blocked.py``), ``chol_factor_solve_lane``'s
  function and contract;
- ``chol_column``: the column loop with one warp per matrix and several
  matrices per block (``experiments/pallas_chol_column.py``);
- ``chol_blocked``: the same in panels, with the trailing update as one
  product per panel (``experiments/pallas_chol_blocked.py``);
- ``smem_sol``: the speed-of-light probe of the lane factor
  (``experiments/vmem_sol.py``).

``layouts`` times them against the production kernels on a card
(``python -m hybdrt_torch.experiments.layouts [B] [n]``). Nothing on a fit or
resolve path calls any of them, as nothing in the JAX package calls the
experiments. All four are float32 only, as their TPU kernels were.
"""
