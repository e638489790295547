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
``sbrd_from_numpy`` (``(ab, vs, ts)`` of ops/sbrd.sbrd), and their planar
twins ``planar_band_from_numpy``, ``planar_chase_from_numpy`` and
``psbrd_from_numpy``, which take and return ``(re, im)`` pairs in the
nesting of ops/sb2st_planar.py and ops/sbrd_planar.py. Each checks the
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


def planar_band_from_numpy(band_r, band_i, b, device="cuda", dtype=None):
    """Both (n, 2b) lower band planes of a Hermitian band (the imaginary
    plane holds -Im of the upper triangle) as contiguous tensors."""
    planes = (band_from_numpy(band_r, b, device, dtype), band_from_numpy(band_i, b, device, dtype))
    if planes[0].shape != planes[1].shape:
        raise ValueError(f"band planes differ in shape: {planes[0].shape}, {planes[1].shape}")
    return planes


def planar_chase_from_numpy(d, e, vt, taut, n, b, device="cuda", dtype=None):
    """(d, (e_r, e_i), (vt_r, vt_i), (taut_r, taut_i)) of a planar bulge
    chase as contiguous tensors in the same nesting."""
    d_t, e_r, vt_r, tt_r = chase_from_numpy(d, e[0], vt[0], taut[0], n, b, device, dtype)
    _, e_i, vt_i, tt_i = chase_from_numpy(d, e[1], vt[1], taut[1], n, b, device, dtype)
    return d_t, (e_r, e_i), (vt_r, vt_i), (tt_r, tt_i)


def psbrd_from_numpy(ab, vs, ts, band, device="cuda", dtype=None):
    """((abr, abi), (vs_r, vs_i), (ts_r, ts_i)) of the planar band
    reduction as contiguous tensors in the same nesting."""
    re = sbrd_from_numpy(ab[0], vs[0], ts[0], band, device, dtype)
    im = sbrd_from_numpy(ab[1], vs[1], ts[1], band, device, dtype)
    return tuple(zip(re, im))
