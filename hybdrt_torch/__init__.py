"""hybdrt_torch: the batched self-tuning QPHB DRT fit in PyTorch, with CUDA
kernels for NVIDIA Hopper.

A port of ``hybdrt_tpu`` (the JAX reference, kept beside it). It mirrors that
package's layout and function names: ``ops/`` (basis, matrix assembly, the
batched box QP, its Cholesky kernels and the fused interior-point kernel),
``csrc/`` (the CUDA sources and their build), ``solver/`` (QPHB updates and the
outer fit loop), ``models/`` (the single-observation ``DRT`` and the EIS and
hybrid problem assembly), ``parallel/`` (the batched fitters: ``batch`` for
spectra on one frequency grid and hybrid observations on one protocol,
``ragged`` for observations on grids of their own), ``mapping/`` (the group
resolve of a fitted map), and ``experiments/`` (the Cholesky layout study, the
counterpart of the repo's ``experiments/`` directory; on no fit or resolve
path). The port imports torch, numpy and scipy, never JAX.

Importing the package turns off TF32 for float32 matrix products and
convolutions, as the JAX package forced true-float32 matmuls: the QP normal
matrices reach condition numbers near 1e7.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .mapping.drtmd import GroupResolveResult, resolve_group  # noqa: E402
from .models.drt import DRT  # noqa: E402
from .parallel.batch import BatchedEISFitter, BatchedHybridFitter, BatchFitResult  # noqa: E402
from .parallel.ragged import BatchedRaggedFitter, RaggedFitResult  # noqa: E402

__all__ = ["BatchedEISFitter", "BatchedHybridFitter", "BatchFitResult", "BatchedRaggedFitter",
           "DRT", "GroupResolveResult", "RaggedFitResult", "resolve_group"]
