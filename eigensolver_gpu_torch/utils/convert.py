"""Carry solver state from the JAX package's world into the port.

The solver holds no weights: its state is the configuration plus the
operands. ``config_from_jax_fields`` rebuilds a :class:`SolverConfig`
from a field dict (``dataclasses.asdict`` of the JAX config);
``planar_from_numpy`` splits complex host matrices into the contiguous
(re, im) device tensors the planar driver takes, as the JAX benchmark
harness does (bench.py); ``dense_from_numpy`` carries the real or complex
dense operands of ``sygvdx`` / ``dsygvdx`` / ``zhegvdx``.

The two-stage reduction's intermediate state crosses the same way, so a
reflector store made by one package can be replayed by the other:
``band_from_numpy`` (lower band storage, ops/sb2st.dense_to_band),
``chase_from_numpy`` (``(d, e, vt, taut)`` of ops/sb2st.bulge_chase) and
``sbrd_from_numpy`` (``(ab, vs, ts)`` of ops/sbrd.sbrd). Each checks the
layout's shapes, and takes ``dtype`` and ``device`` explicitly.
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


def _carry(x, device, dtype):
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def band_from_numpy(band, b, device="cuda", dtype=None):
    """(n, 2b) lower band storage ``B[j, d] = A[j+d, j]`` as a contiguous
    tensor."""
    band = np.asarray(band)
    if band.ndim != 2 or band.shape[1] != 2 * b:
        raise ValueError(f"band must be (n, 2b={2 * b}), got {band.shape}")
    return _carry(band, device, dtype)


def chase_from_numpy(d, e, vt, taut, n, b, device="cuda", dtype=None):
    """(d, e, vt, taut) of a bulge chase as contiguous tensors; the
    reflector store must have the timestep layout of ops/sb2st.py."""
    from eigensolver_gpu_torch.ops.sb2st import chase_dims

    d, e, vt, taut = (np.asarray(x) for x in (d, e, vt, taut))
    s_slots, _, t3 = chase_dims(n, b)
    want = ((n,), (n - 1,), (t3, s_slots, b), (t3, s_slots))
    got = (d.shape, e.shape, vt.shape, taut.shape)
    if got != want:
        raise ValueError(f"chase outputs have shapes {got}, the layout needs {want}")
    return tuple(_carry(x, device, dtype) for x in (d, e, vt, taut))


def sbrd_from_numpy(ab, vs, ts, band, device="cuda", dtype=None):
    """(ab, vs, ts) of the band reduction as contiguous tensors."""
    ab, vs, ts = (np.asarray(x) for x in (ab, vs, ts))
    n = ab.shape[0]
    npanels = n // band - 1
    want = ((n, n), (npanels, n, band), (npanels, band, band))
    got = (ab.shape, vs.shape, ts.shape)
    if got != want:
        raise ValueError(f"sbrd outputs have shapes {got}, the layout needs {want}")
    return tuple(_carry(x, device, dtype) for x in (ab, vs, ts))
