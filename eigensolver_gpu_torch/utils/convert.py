"""Carry solver state from the JAX package's world into the port.

The solver holds no weights: its state is the configuration plus the
operands. ``config_from_jax_fields`` rebuilds a :class:`SolverConfig`
from a field dict (``dataclasses.asdict`` of the JAX config);
``planar_from_numpy`` splits complex host matrices into the contiguous
(re, im) device tensors the planar driver takes, as the JAX benchmark
harness does (bench.py); ``dense_from_numpy`` carries the real or complex
dense operands of ``sygvdx`` / ``dsygvdx`` / ``zhegvdx``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eigensolver_gpu_torch.utils.config import SolverConfig


def config_from_jax_fields(d: dict) -> SolverConfig:
    """SolverConfig from a field dict; unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    if set(d) != names:
        raise ValueError(
            f"field mismatch: extra {sorted(set(d) - names)}, "
            f"missing {sorted(names - set(d))}"
        )
    return SolverConfig(**d)


def planar_from_numpy(a, b, device="cuda", dtype=torch.float64):
    """(ar, ai, br, bi) contiguous tensors from complex host arrays."""
    a = np.asarray(a)
    b = np.asarray(b)
    return tuple(
        torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)
        for x in (a.real, a.imag, b.real, b.imag)
    )


def dense_from_numpy(a, b, device="cuda", dtype=None):
    """(a, b) contiguous dense tensors from real or complex host arrays.
    ``dtype`` None keeps each array's own dtype."""
    return tuple(
        torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device) for x in (a, b)
    )
