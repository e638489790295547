"""Batched generalized solves (twin of the unsharded part of
eigensolver_gpu_tpu/parallel/sharded.py).

``sygvdx_batched`` is the JAX package's ``vmap`` of ``sygvdx`` over a
leading batch axis (BASELINE.md config 4, Quantum ESPRESSO k-points),
for real and complex dtypes. The batch axis runs through every stage of
the pipeline (Cholesky, reduction to standard form, sytrd or the
two-stage reduction, stedc, the back-transforms, phase-4 solve,
refinement), so each column step of the reduction serves the whole batch;
where the two-stage reduction engages, each sbrd panel, the chase and the
Q2 replay are one launch of K5, K7 and K9 for the batch. Only
``use_pallas=True``, whose kernel K4 takes one problem at a time, solves
each item in turn with ``sygvdx``. The mesh-sharded solves are not ported
yet.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.models.sygvdx import SygvdxResult, _sygvdx, sygvdx
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.precision import highest_precision


@highest_precision
def sygvdx_batched(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Solve A_k x = lambda B_k x for a batch of pairs: a, b (batch, n, n).

    Returns SygvdxResult with a leading batch axis: w (batch, m), z
    (batch, n, m), info (batch,) int32. Each item is the solve of
    ``sygvdx`` on it; a B_k that is not positive definite sets its own
    ``info`` and leaves the other items as they are."""
    if a.dim() != 3 or b.shape != a.shape or a.shape[-1] != a.shape[-2]:
        raise ValueError(
            f"sygvdx_batched takes (batch, n, n) pairs of one shape, got "
            f"{tuple(a.shape)}, {tuple(b.shape)}"
        )
    if cfg.use_pallas:
        items = [sygvdx(a[k], b[k], il=il, iu=iu, cfg=cfg) for k in range(a.shape[0])]
        return SygvdxResult(*(torch.stack(f) for f in zip(*items)))
    return _sygvdx(a, b, il, iu, cfg)

