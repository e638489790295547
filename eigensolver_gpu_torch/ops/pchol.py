"""Planar Cholesky of one HPD diagonal block plus its inverse (kernel K1).

Replaces the Pallas kernel ``pchol_block_planar_pallas``
(eigensolver_gpu_tpu/ops/pchol_pallas.py:118, body ``_pchol_block_kernel``
:43). The CUDA source is ``csrc/pchol_block.cu``; its header states what
bounds it on the H100 and how the design answers that.

For an nb x nb planar block (nb <= 128, fp32) it returns
``(ld_r, ld_i, inv_r, inv_i, fail)``: the lower factor ``L_d``, its
explicit inverse (both lower triangular), and ``fail``, the 1-based
index of the first non-positive or NaN pivot (0 if none) as an int32
0-d tensor. A bad pivot is clamped to FLT_MIN (NaN stays NaN) so the
factorization stays finite, exactly as in the Pallas kernel.

A batch of blocks, ``(batch, nb, nb)`` planes, is one launch (one thread
block per item); the outputs gain the leading axis and ``fail`` is
``(batch,)``. Each item's outputs are those of a call on that item alone.

``pchol_block_planar`` is the wrapper: a CUDA tensor launches the
kernel (and raises if it cannot), a CPU tensor takes
``pchol_block_plain``, the plain PyTorch version of the same arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.utils import kernel_guard

NB_MAX = 128


def _pchol_base(ar, ai, nb):
    """Unblocked planar Cholesky of an nb x nb HPD block (lower), or of a
    batch of them (leading axes).

    Returns (lr, li, fail) with ``fail`` the 1-based index of the first
    non-positive/NaN pivot (0 if none), as an int32 tensor of the batch
    shape (0-d for one block); non-positive pivots are clamped to tiny so
    the factorization stays finite, and the caller maps ``fail`` to a
    global devInfo column. Only the lower triangle is read after the
    first step."""
    cr = ar.clone()
    ci = ai.clone()
    fail = torch.zeros(ar.shape[:-2], dtype=torch.int32, device=ar.device)
    tiny = torch.finfo(ar.dtype).tiny
    for j in range(nb):
        pivot = cr[..., j, j]
        bad = (pivot <= 0) | torch.isnan(pivot)
        fail = torch.where(bad & (fail == 0), j + 1, fail)
        dj = torch.sqrt(torch.clamp_min(pivot, tiny))[..., None]  # NaN stays NaN
        col_r = cr[..., j + 1 :, j] / dj
        col_i = ci[..., j + 1 :, j] / dj
        # trailing update: A[r, c] -= col[r] * conj(col[c]) for r, c > j
        cr[..., j + 1 :, j + 1 :] -= _outer(col_r, col_r) + _outer(col_i, col_i)
        ci[..., j + 1 :, j + 1 :] -= _outer(col_i, col_r) - _outer(col_r, col_i)
        cr[..., j, j] = dj[..., 0]
        ci[..., j, j] = 0.0
        cr[..., j + 1 :, j] = col_r
        ci[..., j + 1 :, j] = col_i
    return torch.tril(cr), torch.tril(ci), fail


def _outer(x, y):
    """x y^T for vectors, or for batches of them (leading axes); for
    vectors this is torch.outer's own arithmetic."""
    return x[..., :, None] * y[..., None, :]


def _trinv_downdate(lr, li):
    """inv(L) for a planar lower-triangular L with a real diagonal (or a
    batch of them), by forward substitution on the identity in downdate
    form (row j of the result is final once divided by L[j, j])."""
    nb = lr.shape[-1]
    xr = torch.eye(nb, dtype=lr.dtype, device=lr.device).expand(lr.shape).clone()
    xi = torch.zeros_like(xr)
    for j in range(nb):
        djj = lr[..., j, j, None]
        xr[..., j, :] /= djj
        xi[..., j, :] /= djj
        c_r, c_i = lr[..., j + 1 :, j], li[..., j + 1 :, j]
        xr[..., j + 1 :, :] -= _outer(c_r, xr[..., j, :]) - _outer(c_i, xi[..., j, :])
        xi[..., j + 1 :, :] -= _outer(c_r, xi[..., j, :]) + _outer(c_i, xr[..., j, :])
    return xr, xi


def pchol_block_plain(dr, di):
    """Plain PyTorch version of kernel K1 (same outputs and fail contract),
    for one block or a batch of them."""
    nb = dr.shape[-1]
    ld_r, ld_i, fail = _pchol_base(dr, di, nb)
    inv_r, inv_i = _trinv_downdate(ld_r, ld_i)
    return ld_r, ld_i, inv_r, inv_i, fail


def _check(dr, di):
    nb = dr.shape[-1]
    if dr.dim() not in (2, 3) or dr.shape[-2:] != (nb, nb) or di.shape != dr.shape:
        raise ValueError(
            f"pchol block must be square (with at most one batch axis), got {dr.shape}, {di.shape}"
        )
    if nb > NB_MAX or nb < 1:
        raise ValueError(f"pchol block size must be in 1..{NB_MAX}, got {nb}")
    if dr.dtype != torch.float32 or di.dtype != torch.float32:
        raise TypeError("pchol block kernel takes float32 planes")
    if dr.device != di.device:
        raise ValueError("pchol block planes on different devices")
    # a 1 x 1 block is read at offset 0 whatever its strides (numpy's
    # ``.real`` of a 1 x 1 complex array has strides of two floats)
    if nb > 1 and (dr.stride(-1) != 1 or di.stride(-1) != 1 or dr.stride(-2) != di.stride(-2)):
        raise ValueError("pchol block planes need unit column stride and one row stride")
    if dr.dim() == 3 and dr.shape[0] > 1 and dr.stride(0) != di.stride(0):
        raise ValueError("pchol block planes need one batch stride")


def pchol_block_planar(dr, di):
    """Kernel K1: planar Cholesky of one block (or one launch for a batch
    of blocks) + inv(L_d) + fail."""
    _check(dr, di)
    if dr.device.type == "cpu":
        return pchol_block_plain(dr, di)
    lib = kernel_guard.load("pchol_block")
    fn = lib.pchol_block_planar_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    nb = dr.shape[-1]
    lead = dr.shape[:-2]
    batch = dr.shape[0] if lead else 1
    out = torch.empty((4,) + lead + (nb, nb), dtype=torch.float32, device=dr.device)
    fail = torch.empty(lead, dtype=torch.int32, device=dr.device)
    stream = torch.cuda.current_stream(dr.device).cuda_stream
    status = fn(
        dr.data_ptr(), di.data_ptr(), dr.stride(-2), dr.stride(0) if lead else 0, nb, batch,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
        nb * nb, fail.data_ptr(), stream,
    )
    kernel_guard.check(status, "pchol_block_planar launch")
    pchol_block_planar.launches += 1
    return out[0], out[1], out[2], out[3], fail


pchol_block_planar.launches = 0
