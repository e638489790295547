"""Matmul precision policy: true fp32 wherever the JAX package forces
``'highest'`` (eigensolver_gpu_tpu/utils/precision.py).

On an H100 a float32 product may run in TF32 (10-bit mantissa) when
``torch.backends.cuda.matmul.allow_tf32`` is set, and cuDNN takes TF32
by default. The fp32 pipeline's accuracy contract (eps32 * kappa, which
the fp64 refinement then absorbs) assumes full fp32 products, so every
public entry point runs with both switches off and restores them after.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def true_fp32():
    """Context: TF32 off for matmuls and cuDNN; previous values restored."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def highest_precision(fn):
    """Decorator: run ``fn`` under :func:`true_fp32`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with true_fp32():
            return fn(*args, **kwargs)

    return wrapper
