"""The port's counterpart of the repository's ``experiments/`` directory: the
Cholesky layout study and the fused interior-point loop.

The layout study: four kernels, hand-written CUDA in
``hybdrt_torch/csrc/chol_layouts.cu``, each computing the function of a
production lane kernel (``hybdrt_torch/ops/chol_lane.py``) in another layout:

- ``chol_lane_blocked``: the panel-blocked factor and solve
  (``experiments/pallas_chol_lane_blocked.py``), ``chol_factor_solve_lane``'s
  function and contract, on that kernel's register tiles with panels of kb
  columns;
- ``chol_column``: the column Cholesky with one warp per matrix on its
  packed lower triangle and several matrices per block
  (``experiments/pallas_chol_column.py``);
- ``chol_blocked``: the same kernel in the TPU kernel's order of panels of
  nb columns, each earlier panel's products summed apart
  (``experiments/pallas_chol_blocked.py``);
- ``smem_sol``: the speed-of-light probe of the lane factor
  (``experiments/vmem_sol.py``).

``layouts`` times them against the production kernels on a card
(``python -m hybdrt_torch.experiments.layouts [B] [n]``).

``ip_loop``: ``ip_steps_loop``, the fused Mehrotra steps of
``experiments/pallas_ip_loop.py`` with that TPU kernel's full-step corrector
rule, which is the production fused kernel of ``hybdrt_torch/csrc/ip_lane.cu``
with the other rule; ``python -m hybdrt_torch.experiments.ip_loop [B] [n]
[T]`` checks it against its plain version and the experiment's reference and
times it in turns with ``ip_steps_lane``.

Nothing on a fit or resolve path calls any of them, as nothing in the JAX
package calls the experiments. All five are float32 only, as their TPU
kernels were.
"""
