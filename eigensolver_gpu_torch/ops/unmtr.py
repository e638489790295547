"""Blocked WY back-transformation (ormtr/unmtr, side='L', uplo='U'; twin
of eigensolver_gpu_tpu/ops/unmtr.py).

Applies ``Q = H(n-2) ... H(1) H(0)`` from sytrd/hetrd to a matrix of
tridiagonal eigenvectors: ``C <- Q @ C``.

Reference: the custom dormtr/zunmtr loop in dsyevd_gpu.F90:119-128 /
zheevd_gpu.F90:121-130 -- per block, ``dlarft_gpu`` forms the triangular
T factor and ``dlarfb_gpu`` applies ``I - V T V^H`` with gemm/trmm/gemm.
Here every block's V is extracted and every T built at once (the larft
row recurrence batched over the blocks), then each block is applied with
three gemms. One implementation serves the real and complex cases.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _block_v(a_packed, r0, kb, nref):
    """Columns of V for reflectors r0..r0+kb-1 out of sytrd's packed storage.

    Reflector r lives in packed column r+1: v[0:r] = a[0:r, r+1], v[r] = 1,
    v[r+1:] = 0 (LAPACK UPLO='U' convention, see ops/sytrd.py). Reflector
    indices >= nref (ragged last block) come out as zero columns, which
    combined with tau = 0 make H = I. ``a_packed`` must have at least
    r0 + 1 + kb columns.
    """
    n = a_packed.shape[-2]
    cols = a_packed[..., :, r0 + 1 : r0 + 1 + kb]
    rows = torch.arange(n, device=a_packed.device)[:, None]
    refl = torch.arange(kb, device=a_packed.device)[None, :] + r0
    valid = refl < nref
    v = torch.where((rows < refl) & valid, cols, torch.zeros_like(cols))
    return torch.where((rows == refl) & valid, torch.ones_like(cols), v)


def _larft_left(v, tau_blk):
    """T for the left-product H(r0+kb-1)...H(r0) = I - V T V^H.

    Prepending H_new to I - V T V^H appends row
    ``[-tau_new v^H V T, tau_new]`` -- a kb-step recurrence on rows of T.
    """
    return _larft_left_batched(v[None], tau_blk[None])[0]


def _larft_left_batched(v, tau):
    """_larft_left for a stack of blocks at once (leading axes): the
    per-block row recurrences are independent, so one loop over kb rows
    builds every T (sequential depth kb instead of kb * nblocks)."""
    kb = v.shape[-1]
    m = v.mH @ v  # m[b, j, i] = v_j^H v_i
    t = torch.zeros(v.shape[:-2] + (kb, kb), dtype=v.dtype, device=v.device)
    for j in range(kb):
        row = (m[..., j : j + 1, :j] @ t[..., :j, :]).squeeze(-2)
        t[..., j, :] = -tau[..., j, None] * row
        t[..., j, j] = tau[..., j]
    return t


@highest_precision
def unmtr(a_packed, tau, c, nb=128):
    """C <- Q @ C with Q from sytrd's packed reflectors. Blocked WY apply;
    the ragged tail is padded with tau = 0 identity reflectors. Leading
    axes are a batch of problems."""
    n = a_packed.shape[-1]
    nref = n - 1
    if nref <= 0:
        return c
    lead = a_packed.shape[:-2]
    nblocks = -(-nref // nb)
    tau_pad = torch.cat([tau, tau.new_zeros(lead + (nblocks * nb - nref,))], -1)
    tau_pad = tau_pad.reshape(lead + (nblocks, nb))
    a_ext = torch.cat([a_packed, a_packed.new_zeros(lead + (n, nblocks * nb + 1 - n))], -1)

    with trace_range("unmtr"):
        v_all = torch.stack([_block_v(a_ext, k * nb, nb, nref) for k in range(nblocks)], -3)
        t_all = _larft_left_batched(v_all, tau_pad)
        for i in range(nblocks):
            # C <- (I - V T V^H) C : two gemms + one small triangular gemm
            v = v_all[..., i, :, :]
            c = c - v @ (t_all[..., i, :, :] @ (v.mH @ c))
        return c


def ungtr(a_packed, tau, nb=128):
    """Explicitly form Q (LAPACK dorgtr/zungtr analogue), for tests/debug."""
    n = a_packed.shape[0]
    eye = torch.eye(n, dtype=a_packed.dtype, device=a_packed.device)
    return unmtr(a_packed, tau, eye, nb=nb)
