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

A leading batch axis (the JAX kernels under ``jax.vmap``): ``a`` (B, n, n)
with one row stride and one batch stride, ``v`` (B, n), ``y`` (B, n);
``extent`` applies to every item. A batch is one launch, and every item's
``y`` has the bits of the unbatched launch on it.

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
call to call. A batch keeps each item's unbatched split of the tiles
(its virtual blocks); the grid walks the (item, virtual block) pairs.

C entries (``csrc/symv.cu``): ``symv_f32_launch`` / ``symv_f64_launch``
``(a, lda, sa, n, v, sv, part, y, batch, stream)`` and
``hemv_planar_launch(ar, ai, lda, sa, n, vr, vi, sv, part, y, batch,
stream)``; ``sa``, ``sv`` are the batch strides, ``part`` is a scratch of
``batch * symv_part_elems(n, planes)`` elements.

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


def _scratch(n, planes, batch, dtype, device):
    """The partial-sum scratch of the kernels (``symv_part_elems`` an item)."""
    elems = _bind("symv_part_elems", [ctypes.c_int, ctypes.c_int], ctypes.c_longlong)
    return torch.empty((batch * elems(n, planes),), dtype=dtype, device=device)


def _upper_tiles(n, tile):
    for r0 in range(0, n, tile):
        for c0 in range(r0, n, tile):
            yield slice(r0, min(r0 + tile, n)), slice(c0, min(c0 + tile, n))


def _mv(m, x):
    """m @ x for a matrix and a vector, or for batches of each."""
    return m @ x if x.dim() == 1 else (m @ x[..., None])[..., 0]


def symv_plain(a, v, tile=TILE):
    """Plain PyTorch version of kernel K4 (same contract, same tile walk)."""
    y = torch.zeros_like(v)
    for rows, cols in _upper_tiles(a.shape[-1], tile):
        t = a[..., rows, cols]
        y[..., rows] += _mv(t, v[..., cols])
        if rows != cols:
            y[..., cols] += _mv(t.mT, v[..., rows])
    return y


def hemv_planar_plain(ar, ai, vr, vi, tile=TILE):
    """Plain PyTorch version of kernel K3 (same contract, same tile walk)."""
    yr = torch.zeros_like(vr)
    yi = torch.zeros_like(vi)
    for rows, cols in _upper_tiles(ar.shape[-1], tile):
        tr, ti = ar[..., rows, cols], ai[..., rows, cols]
        yr[..., rows] += _mv(tr, vr[..., cols]) - _mv(ti, vi[..., cols])
        yi[..., rows] += _mv(tr, vi[..., cols]) + _mv(ti, vr[..., cols])
        if rows != cols:
            yr[..., cols] += _mv(tr.mT, vr[..., rows]) + _mv(ti.mT, vi[..., rows])
            yi[..., cols] += _mv(tr.mT, vi[..., rows]) - _mv(ti.mT, vr[..., rows])
    return yr, yi


def _restrict(mats, vecs, extent):
    """Leading extent x extent blocks and vector heads (views)."""
    if extent is None:
        return mats, vecs
    c = int(extent)
    if not 1 <= c <= mats[0].shape[-1]:
        raise ValueError(f"extent must be in 1..{mats[0].shape[-1]}, got {c}")
    return [m[..., :c, :c] for m in mats], [x[..., :c] for x in vecs]


def _check(mats, vecs, what):
    """Square matrices with at most one leading batch axis, vectors to
    match; the layout the kernels read (one row and one batch stride)."""
    first = mats[0]
    n, lead = first.shape[-1], tuple(first.shape[:-2])
    if n < 1 or len(lead) > 1 or any(m.shape != lead + (n, n) for m in mats):
        raise ValueError(f"{what}: matrices must be square and non-empty, with at most one "
                         f"batch axis, got {[tuple(m.shape) for m in mats]}")
    if any(x.shape != lead + (n,) for x in vecs):
        raise ValueError(f"{what}: vectors must have shape {lead + (n,)}, "
                         f"got {[tuple(x.shape) for x in vecs]}")
    for x in (*mats, *vecs):
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError(f"{what}: operands differ in dtype or device")
    if first.is_complex() or not first.is_floating_point():
        raise TypeError(f"{what} takes real floating-point tensors, got {first.dtype}")
    if any(m.stride() != first.stride() for m in mats) or first.stride(-1) != 1:
        raise ValueError(f"{what}: matrices need unit column stride and one row stride")


def _layout(a, vecs):
    """(batch, batch stride of the matrices, the vectors as contiguous
    (batch, n) rows) of a batched or unbatched call."""
    batch = a.shape[0] if a.dim() == 3 else 1
    sa = a.stride(0) if a.dim() == 3 and batch > 1 else 0
    return batch, sa, [x.contiguous() for x in vecs]


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
    V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _bind(name, [V, I, L, I, V, L, V, V, I, V])
    n = a.shape[-1]
    batch, sa, (v,) = _layout(a, [v])
    part = _scratch(n, 1, batch, a.dtype, a.device)
    y = torch.empty(v.shape, dtype=a.dtype, device=a.device)
    status = fn(a.data_ptr(), a.stride(-2), sa, n, v.data_ptr(), n, part.data_ptr(),
                y.data_ptr(), batch, torch.cuda.current_stream(a.device).cuda_stream)
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
    V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _bind("hemv_planar_launch", [V, V, I, L, I, V, V, L, V, V, I, V])
    n = ar.shape[-1]
    batch, sa, (vr, vi) = _layout(ar, [vr, vi])
    part = _scratch(n, 2, batch, torch.float32, ar.device)
    y = torch.empty(vr.shape[:-1] + (2, n), dtype=torch.float32, device=ar.device)
    status = fn(ar.data_ptr(), ai.data_ptr(), ar.stride(-2), sa, n, vr.data_ptr(),
                vi.data_ptr(), n, part.data_ptr(), y.data_ptr(), batch,
                torch.cuda.current_stream(ar.device).cuda_stream)
    kernel_guard.check(status, "hemv_planar launch")
    hemv_planar.launches += 1
    return y[..., 0, :], y[..., 1, :]


hemv_planar.launches = 0
