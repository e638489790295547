"""Reduction of the generalized problem to standard form (sygst/hegst;
twin of eigensolver_gpu_tpu/ops/sygst.py).

Given ``B = U^H U`` (upper Cholesky) and symmetric/Hermitian ``A``,
computes ``C = U^{-H} A U^{-1}`` so that ``A x = lambda B x`` becomes
``C y = lambda y`` with ``x = U^{-1} y`` (ITYPE=1, UPLO='U').

Reference: dsygst_gpu.F90:31-100 / zhegst_gpu.F90:31-111, a blocked
recurrence of trsm/gemm/syr2k steps. Three forms, as in the JAX package:
two whole-matrix triangular solves (``sygst_full``), the reference-shaped
blocked recurrence (``sygst_blocked``), and the inverse-diagonal blocked
solves of ops/trsm.py (``sygst_inv``, fp32 pipelines only).

The JAX ``sygst_blocked`` pads to whole blocks, groups them into
fixed-shape buckets and masks the trailing extents, all for XLA's static
shapes; the port slices the exact trailing block (the last block may be
ragged), which gives the same C. Every form takes a batch of problems on
leading axes.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.trsm import (
    trsm_left_upper_trans_inv,
    trsm_right_upper_inv,
)
from eigensolver_gpu_torch.utils.precision import highest_precision


def _tsolve(u, b, *, left, trans):
    """x with op(U) x = b (left) or x op(U) = b (right); U upper
    triangular, op = conjugate transpose when ``trans``."""
    if trans:
        return torch.linalg.solve_triangular(u.mH, b, upper=False, left=left)
    return torch.linalg.solve_triangular(u, b, upper=True, left=left)


def _herm(c):
    return (c + c.mH) / 2


@highest_precision
def sygst_full(a, u):
    """Whole-matrix C = U^{-H} A U^{-1} via two triangular solves."""
    x = _tsolve(u, a, left=True, trans=True)  # X = U^{-H} A
    return _herm(_tsolve(u, x, left=False, trans=False))  # C = X U^{-1}


@highest_precision
def sygst_blocked(a, u, nb=512, n_buckets=4):
    """Blocked LAPACK-style recurrence (dsygst_gpu.F90:50-96 shape).

    Per block k (size nb): transform the diagonal block, then update the
    trailing panel with trsm -> gemm(-1/2) -> her2k -> gemm(-1/2) -> trsm.

    ``n_buckets`` is kept for the JAX signature and has no effect: it
    bounds the number of JAX's traced loops, and this loop is eager, one
    exact block at a time, so every value gives the same C.
    """
    del n_buckets
    n = a.shape[-1]
    a = _herm(a)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        ukk = u[..., k0:k1, k0:k1]
        # diagonal block: U_kk^{-H} A_kk U_kk^{-1}
        akk = _tsolve(ukk, a[..., k0:k1, k0:k1], left=True, trans=True)
        akk = _herm(_tsolve(ukk, akk, left=False, trans=False))
        a[..., k0:k1, k0:k1] = akk
        if k1 == n:
            break
        # trailing panel update (dsygst_gpu.F90:76-93)
        ukt = u[..., k0:k1, k1:]
        akt = _tsolve(ukk, a[..., k0:k1, k1:], left=True, trans=True)
        akt = akt - 0.5 * akk @ ukt
        upd = akt.mH @ ukt
        a[..., k1:, k1:] = _herm(a[..., k1:, k1:] - (upd + upd.mH))
        akt = akt - 0.5 * akk @ ukt
        akt = _tsolve(u[..., k1:, k1:], akt, left=False, trans=False)
        a[..., k0:k1, k1:] = akt
        a[..., k1:, k0:k1] = akt.mH
    return a


@highest_precision
def sygst_inv(a, u, nb=512):
    """C = U^{-H} A U^{-1} via the inverse-diagonal blocked solves
    (ops/trsm.py): both triangular solves become n/nb steps of one
    correction gemm + one block gemm each.

    Forward error ~eps * kappa(U_block) per solve (explicit block
    inverses): fp32-pipeline use only, where the fp64 refinement absorbs
    it; the fp64 path keeps sygst_full/sygst_blocked. Requires
    n % nb == 0 and nb = 16 * 2^j.
    """
    x = trsm_left_upper_trans_inv(u, a, nb=nb)  # X = U^{-H} A
    return _herm(trsm_right_upper_inv(u, x, nb=nb))  # C = X U^{-1}


def sygst(a, u, mode="full", nb=512):
    """Dispatch: 'full' (two whole-matrix trsm), 'blocked' recurrence,
    or 'inv' (inverse-diagonal blocked solves, fp32 pipelines)."""
    if mode == "full":
        return sygst_full(a, u)
    if mode == "inv":
        return sygst_inv(a, u, nb=nb)
    return sygst_blocked(a, u, nb=nb)
