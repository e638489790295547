"""Symmetric and planar Hermitian matrix-vector products from the upper
tiles only (kernels K4 and K3).

Replace the Pallas kernels ``symv``
(eigensolver_gpu_tpu/ops/symv_pallas.py:90; ``pallas_call`` :117,
``_symv_kernel`` :58) and ``hemv_planar``
(eigensolver_gpu_tpu/ops/hemv_pallas.py:70; ``pallas_call`` :100,
``_hemv_kernel`` :39), the counterparts of the reference's ``dsymv_gpu``
and ``zhemv_gpu``. The CUDA source is ``csrc/symv.cu``; its header states
what bounds the kernels on the H100, and the ordering scheme that makes
the result bit-reproducible without atomics.

Contracts:

* ``symv(a, v)``: ``y = A v`` for a symmetric, full-stored (mirrored)
  real ``a`` (n, n) and ``v`` (n,). Only tiles on or above the diagonal
  are read; each off-diagonal tile serves both ``y[bi] += T v[bj]`` and
  ``y[bj] += T^T v[bi]``.
* ``hemv_planar(ar, ai, vr, vi)``: ``(yr, yi) = (Ar + i Ai)(vr + i vi)``
  with ``Ar`` symmetric and ``Ai`` antisymmetric, both full-stored.

Both take any n >= 1 (the Pallas kernels' ``n % (2 * tile) == 0`` rule
belongs to their reflection grid and is not carried over, nor is their
``tile`` argument) and a matrix that is a view with unit column stride
(the tridiagonalization passes ``a[:mb, :mb]`` of the padded matrix).
``extent=c`` restricts the product to the leading c x c block and the
first c entries of the vectors; the result then has length c.

``symv`` and ``hemv_planar`` are the wrappers: CUDA tensors launch the
kernel (and raise if it cannot be built or launched), CPU tensors take
``symv_plain`` / ``hemv_planar_plain``, plain PyTorch walks of the same
upper tiles. The kernels take float32 (K4 also float64).
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.utils import kernel_guard

TILE = 64  # kTile of csrc/symv.cu


def _upper_tiles(n, tile):
    for r0 in range(0, n, tile):
        for c0 in range(r0, n, tile):
            yield slice(r0, min(r0 + tile, n)), slice(c0, min(c0 + tile, n))


def symv_plain(a, v, tile=TILE):
    """Plain PyTorch version of kernel K4 (same contract, same tile walk)."""
    y = torch.zeros_like(v)
    for rows, cols in _upper_tiles(a.shape[0], tile):
        t = a[rows, cols]
        y[rows] += t @ v[cols]
        if rows != cols:
            y[cols] += t.T @ v[rows]
    return y


def hemv_planar_plain(ar, ai, vr, vi, tile=TILE):
    """Plain PyTorch version of kernel K3 (same contract, same tile walk)."""
    yr = torch.zeros_like(vr)
    yi = torch.zeros_like(vi)
    for rows, cols in _upper_tiles(ar.shape[0], tile):
        tr, ti = ar[rows, cols], ai[rows, cols]
        yr[rows] += tr @ vr[cols] - ti @ vi[cols]
        yi[rows] += tr @ vi[cols] + ti @ vr[cols]
        if rows != cols:
            yr[cols] += tr.T @ vr[rows] + ti.T @ vi[rows]
            yi[cols] += tr.T @ vi[rows] - ti.T @ vr[rows]
    return yr, yi


def _restrict(mats, vecs, extent):
    """Leading extent x extent blocks and vector heads (views)."""
    if extent is None:
        return mats, vecs
    c = int(extent)
    if not 1 <= c <= mats[0].shape[0]:
        raise ValueError(f"extent must be in 1..{mats[0].shape[0]}, got {c}")
    return [m[:c, :c] for m in mats], [x[:c] for x in vecs]


def _check(mats, vecs, what):
    n = mats[0].shape[0]
    if n < 1 or any(m.shape != (n, n) for m in mats):
        raise ValueError(f"{what}: matrices must be square and non-empty, "
                         f"got {[tuple(m.shape) for m in mats]}")
    if any(x.shape != (n,) for x in vecs):
        raise ValueError(f"{what}: vectors must have shape ({n},), "
                         f"got {[tuple(x.shape) for x in vecs]}")
    first = mats[0]
    for x in (*mats, *vecs):
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError(f"{what}: operands differ in dtype or device")
    if first.is_complex() or not first.is_floating_point():
        raise TypeError(f"{what} takes real floating-point tensors, got {first.dtype}")
    if any(m.stride(1) != 1 or m.stride(0) != first.stride(0) for m in mats):
        raise ValueError(f"{what}: matrices need unit column stride and one row stride")


def symv(a, v, extent=None):
    """Kernel K4: y = A v from the upper tiles (see the module docstring)."""
    (a,), (v,) = _restrict([a], [v], extent)
    _check([a], [v], "symv")
    if a.device.type == "cpu":
        return symv_plain(a, v)
    if a.dtype == torch.float32:
        name = "symv_f32_launch"
    elif a.dtype == torch.float64:
        name = "symv_f64_launch"
    else:
        raise TypeError(f"the symv kernel takes float32 or float64, got {a.dtype}")
    fn = getattr(kernel_guard.load("symv"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    n = a.shape[0]
    v = v.contiguous()
    part = torch.empty((-(-n // TILE), n), dtype=a.dtype, device=a.device)
    y = torch.empty((n,), dtype=a.dtype, device=a.device)
    status = fn(
        a.data_ptr(), a.stride(0), n, v.data_ptr(), part.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    kernel_guard.check(status, "symv launch")
    symv.launches += 1
    return y


symv.launches = 0


def hemv_planar(ar, ai, vr, vi, extent=None):
    """Kernel K3: (yr, yi) = (Ar + i Ai)(vr + i vi) from the upper tiles
    (see the module docstring)."""
    (ar, ai), (vr, vi) = _restrict([ar, ai], [vr, vi], extent)
    _check([ar, ai], [vr, vi], "hemv_planar")
    if ar.device.type == "cpu":
        return hemv_planar_plain(ar, ai, vr, vi)
    if ar.dtype != torch.float32:
        raise TypeError(f"the hemv_planar kernel takes float32, got {ar.dtype}")
    fn = kernel_guard.load("symv").hemv_planar_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    n = ar.shape[0]
    vr, vi = vr.contiguous(), vi.contiguous()
    part = torch.empty((2, -(-n // TILE), n), dtype=torch.float32, device=ar.device)
    y = torch.empty((2, n), dtype=torch.float32, device=ar.device)
    status = fn(
        ar.data_ptr(), ai.data_ptr(), ar.stride(0), n, vr.data_ptr(), vi.data_ptr(),
        part.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(ar.device).cuda_stream,
    )
    kernel_guard.check(status, "hemv_planar launch")
    hemv_planar.launches += 1
    return y[0], y[1]


hemv_planar.launches = 0
