"""Symmetric and planar Hermitian matrix-vector products from the upper
tiles only (kernels K4 and K3).

Replace the Pallas kernels ``symv``
(eigensolver_gpu_tpu/ops/symv_pallas.py:90; ``pallas_call`` :117,
``_symv_kernel`` :58) and ``hemv_planar``
(eigensolver_gpu_tpu/ops/hemv_pallas.py:70; ``pallas_call`` :100,
``_hemv_kernel`` :39), the counterparts of the reference's ``dsymv_gpu``
and ``zhemv_gpu``. The CUDA source is ``csrc/symv.cu``.

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

What bounds the kernels on the H100: bytes, the upper tiles read once
(33.6 MB for K4 at n = 4096 in fp32, 67.1 MB for K3's two planes and for
K4 in fp64). K4's fp32 triangle fits in the 50 MB L2 up to n of about
5000, so the 32 calls of a sytrd panel on one block find it warm; K3's
planes do not fit. At small extents the launch and the latency of the
final sums dominate.

Design (the header of ``csrc/symv.cu`` has the details): one cooperative
launch a call. The upper 64 x 64 tiles, numbered column strip by column
strip, are shared out in runs of consecutive tiles as evenly as integers
allow over a grid of resident blocks (one wave). A block stages its tiles
through a cp.async ring of shared-memory stages (16-byte copies
where the rows are 16-byte aligned, element copies otherwise), writes
each off-diagonal tile's row product as a partial and keeps its column
products in registers over each strip's run. Ordering: after a grid
barrier every output row is summed from its partials in a fixed order,
the rows spread over all blocks. No float atomics; the same bits from
call to call.

C entries (``csrc/symv.cu``): ``symv_f32_launch`` / ``symv_f64_launch``
``(a, lda, n, v, part, y, stream)`` and ``hemv_planar_launch(ar, ai, lda,
n, vr, vi, part, y, stream)``; ``part`` is a scratch of
``symv_part_elems(n, planes)`` elements.

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


def _bind(name, argtypes, restype=ctypes.c_int):
    fn = getattr(kernel_guard.load("symv"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, restype
    return fn


def _scratch(n, planes, dtype, device):
    """The partial-sum scratch of the kernels (``symv_part_elems``)."""
    elems = _bind("symv_part_elems", [ctypes.c_int, ctypes.c_int], ctypes.c_longlong)
    return torch.empty((elems(n, planes),), dtype=dtype, device=device)


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
    fn = _bind(name, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    n = a.shape[0]
    v = v.contiguous()
    part = _scratch(n, 1, a.dtype, a.device)
    y = torch.empty((n,), dtype=a.dtype, device=a.device)
    status = fn(a.data_ptr(), a.stride(0), n, v.data_ptr(), part.data_ptr(), y.data_ptr(),
                torch.cuda.current_stream(a.device).cuda_stream)
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
    fn = _bind("hemv_planar_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 5)
    n = ar.shape[0]
    vr, vi = vr.contiguous(), vi.contiguous()
    part = _scratch(n, 2, torch.float32, ar.device)
    y = torch.empty((2, n), dtype=torch.float32, device=ar.device)
    status = fn(ar.data_ptr(), ai.data_ptr(), ar.stride(0), n, vr.data_ptr(), vi.data_ptr(),
                part.data_ptr(), y.data_ptr(), torch.cuda.current_stream(ar.device).cuda_stream)
    kernel_guard.check(status, "hemv_planar launch")
    hemv_planar.launches += 1
    return y[0], y[1]


hemv_planar.launches = 0
