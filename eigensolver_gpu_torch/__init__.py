"""PyTorch/CUDA port of the generalized Hermitian-definite eigensolver.

A second package beside the JAX one (``eigensolver_gpu_tpu``), which
stays the reference it is held against. It mirrors that package's
layout (``models/ ops/ parallel/ utils/``) so each module has one named twin, and
keeps its public contracts:

    >>> from eigensolver_gpu_torch import zhegvdx_planar, SolverConfig
    >>> w, zr, zi, info = zhegvdx_planar(ar, ai, br, bi, il=1, iu=1024,
    ...                                  cfg=SolverConfig(compute_dtype="float32"))

    >>> from eigensolver_gpu_torch import dsygvdx
    >>> w, z, info = dsygvdx(a, b, il=1, iu=512,
    ...                      cfg=SolverConfig(compute_dtype="float32"))

Entry points run on the device of their input tensors: CUDA tensors on
the card (the hand-written kernels under ``csrc/`` are built on first
use and a failure to build or launch raises), CPU tensors through the
kernels' plain PyTorch versions. ``zhegvdx_planar_host`` takes complex
numpy arrays and a ``device`` (the card by default), as do ``dsygvdx``
and ``zhegvdx`` when they are given numpy arrays.

Batches of problems (k-point batches) go to ``zhegvdx_planar_batched``
and ``sygvdx_batched``: ``(batch, n, n)`` tensors in, results with a
leading batch axis out.
"""

from eigensolver_gpu_torch.models.syevdx import syevdx
from eigensolver_gpu_torch.models.sygvdx import SygvdxResult, dsygvdx, sygvdx, zhegvdx
from eigensolver_gpu_torch.models.zhegvdx_planar import (
    PlanarResult,
    zhegvdx_planar,
    zhegvdx_planar_batched,
    zhegvdx_planar_host,
)
from eigensolver_gpu_torch.parallel.sharded import sygvdx_batched
from eigensolver_gpu_torch.utils.config import SolverConfig

__all__ = [
    "PlanarResult",
    "SolverConfig",
    "SygvdxResult",
    "dsygvdx",
    "syevdx",
    "sygvdx",
    "sygvdx_batched",
    "zhegvdx",
    "zhegvdx_planar",
    "zhegvdx_planar_batched",
    "zhegvdx_planar_host",
]
