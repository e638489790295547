"""Planar complex linear algebra: complex matrices as (re, im) real pairs
(twin of eigensolver_gpu_tpu/ops/planar.py).

The JAX package splits complex matrices because its TPU stack has no
complex dtype; the port keeps the planar contract so each stage can be
held against the JAX package, and so the hand-written kernels take two
real planes:

  * ``pmatmul``               -- 3-multiplication Karatsuba complex gemm
  * ``pcholesky_lower``       -- left-looking blocked planar Cholesky
  * ``ptrsm_left_lower``      -- blocked forward substitution, L X = B
  * ``ptrsm_left_lower_inv``  -- the same with inverted diagonal blocks
  * ``ptrsm_left_upper``      -- U X = B via the flip identity

A planar array is a ``(re, im)`` tuple of equal-shape real tensors. The
JAX package's fixed-shape tricks (masked full-width gemms, the 4-segment
bucketing of ``_chol_segments``) exist for XLA's static shapes; eager
PyTorch slices the exact triangle instead. ``ptrinv_lower`` and the
``'trinv'`` solve mode are not ported yet.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.pchol import _pchol_base, pchol_block_planar
from eigensolver_gpu_torch.utils.precision import highest_precision


def pH(x):
    """Conjugate transpose."""
    return (x[0].T, -x[1].T)


def pmatmul(x, y):
    """Karatsuba complex product: 3 real gemms instead of 4."""
    m1 = x[0] @ y[0]
    m2 = x[1] @ y[1]
    m3 = (x[0] + x[1]) @ (y[0] + y[1])
    return (m1 - m2, m3 - m1 - m2)


def pmatmul_chunked(x, y, chunk):
    """pmatmul with the columns of y taken ``chunk`` at a time, so only
    one chunk's temporaries are alive at once."""
    m = y[0].shape[1]
    if chunk is None or chunk >= m or m % chunk != 0:
        return pmatmul(x, y)
    parts = [pmatmul(x, (y[0][:, c : c + chunk], y[1][:, c : c + chunk]))
             for c in range(0, m, chunk)]
    return (torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1))


def _fsub_base(lr, li, br, bi, nb):
    """Forward substitution for the nb x nb planar lower block L X = B."""
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    for i in range(nb):
        acc_r = lr[i, :i] @ xr[:i] - li[i, :i] @ xi[:i]
        acc_i = lr[i, :i] @ xi[:i] + li[i, :i] @ xr[:i]
        num_r = br[i] - acc_r
        num_i = bi[i] - acc_i
        dr = lr[i, i]
        di = li[i, i]
        den = dr * dr + di * di
        safe = torch.where(den == 0, torch.ones_like(den), den)
        xr[i] = (num_r * dr + num_i * di) / safe
        xi[i] = (num_i * dr - num_r * di) / safe
    return xr, xi


def _ptrinv_batched(lr, li, base=16):
    """Batched inverse of planar lower-triangular blocks (B, k, k) by
    recursive block inversion inv([[A,0],[C,D]]) = [[iA,0],[-iD C iA, iD]]:
    sequential depth base + log2(k/base) instead of k rows."""
    k = lr.shape[-1]
    if k <= base:
        xr = torch.zeros_like(lr)
        xi = torch.zeros_like(li)
        eye = torch.eye(k, dtype=lr.dtype, device=lr.device)
        for i in range(k):
            lrow_r = lr[:, i, :i].unsqueeze(1)
            lrow_i = li[:, i, :i].unsqueeze(1)
            acc_r = (lrow_r @ xr[:, :i] - lrow_i @ xi[:, :i]).squeeze(1)
            acc_i = (lrow_r @ xi[:, :i] + lrow_i @ xr[:, :i]).squeeze(1)
            rhs_r = eye[i] - acc_r
            rhs_i = -acc_i
            dr = lr[:, i, i, None]
            di = li[:, i, i, None]
            den = dr * dr + di * di
            safe = torch.where(den == 0, torch.ones_like(den), den)
            xr[:, i] = (rhs_r * dr + rhs_i * di) / safe
            xi[:, i] = (rhs_i * dr - rhs_r * di) / safe
        return xr, xi
    h = k // 2
    ia_r, ia_i = _ptrinv_batched(lr[:, :h, :h], li[:, :h, :h], base)
    id_r, id_i = _ptrinv_batched(lr[:, h:, h:], li[:, h:, h:], base)
    cr, ci = lr[:, h:, :h], li[:, h:, :h]
    t_r = cr @ ia_r - ci @ ia_i
    t_i = cr @ ia_i + ci @ ia_r
    m_r = id_r @ t_r - id_i @ t_i
    m_i = id_r @ t_i + id_i @ t_r
    out_r = torch.zeros_like(lr)
    out_i = torch.zeros_like(li)
    out_r[:, :h, :h], out_i[:, :h, :h] = ia_r, ia_i
    out_r[:, h:, :h], out_i[:, h:, :h] = -m_r, -m_i
    out_r[:, h:, h:], out_i[:, h:, h:] = id_r, id_i
    return out_r, out_i


def _diag_blocks(x, nb):
    n = x.shape[0]
    return torch.stack([x[k : k + nb, k : k + nb] for k in range(0, n, nb)])


@highest_precision
def ptrsm_left_lower_inv(l, b, nb=128):
    """L X = B via batched-inverted diagonal blocks + blocked forward
    substitution: n/nb sequential steps. Forward error ~eps * kappa of
    the diagonal blocks -- the fp32 pipeline's choice, which the fp64
    refinement absorbs; the fp64 path keeps pure substitution."""
    lr, li = l
    br, bi = b
    n = lr.shape[0]
    if n % nb != 0:
        raise ValueError(f"ptrsm requires n % nb == 0, got n={n}, nb={nb}")
    inv_r, inv_i = _ptrinv_batched(_diag_blocks(lr, nb), _diag_blocks(li, nb))
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    for k, k0 in enumerate(range(0, n, nb)):
        rows = slice(k0, k0 + nb)
        lrow = (lr[rows, :k0], li[rows, :k0])
        acc_r = lrow[0] @ xr[:k0] - lrow[1] @ xi[:k0]
        acc_i = lrow[0] @ xi[:k0] + lrow[1] @ xr[:k0]
        rhs_r = br[rows] - acc_r
        rhs_i = bi[rows] - acc_i
        xr[rows] = inv_r[k] @ rhs_r - inv_i[k] @ rhs_i
        xi[rows] = inv_r[k] @ rhs_i + inv_i[k] @ rhs_r
    return xr, xi


@highest_precision
def ptrsm_left_lower(l, b, nb=128):
    """Solve L X = B with planar lower-triangular L (n x n), B (n x m):
    blocked forward substitution with nb-row substitution on each
    diagonal block."""
    lr, li = l
    br, bi = b
    n = lr.shape[0]
    if n % nb != 0:
        raise ValueError(f"ptrsm requires n % nb == 0, got n={n}, nb={nb}")
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    for k0 in range(0, n, nb):
        rows = slice(k0, k0 + nb)
        acc_r = lr[rows, :k0] @ xr[:k0] - li[rows, :k0] @ xi[:k0]
        acc_i = lr[rows, :k0] @ xi[:k0] + li[rows, :k0] @ xr[:k0]
        xr[rows], xi[rows] = _fsub_base(
            lr[rows, rows], li[rows, rows], br[rows] - acc_r, bi[rows] - acc_i, nb
        )
    return xr, xi


def ptrsm_left_upper(u, b, nb=128, solve_lower=ptrsm_left_lower):
    """Solve U X = B with planar upper-triangular U via the flip identity
    (P U P is lower triangular for the reversal permutation P), using
    ``solve_lower`` (``ptrsm_left_lower`` or ``ptrsm_left_lower_inv``)
    on the flipped system."""
    fl = lambda m: torch.flip(m, (0, 1))
    flv = lambda m: torch.flip(m, (0,))
    xr, xi = solve_lower((fl(u[0]), fl(u[1])), (flv(b[0]), flv(b[1])), nb=nb)
    return flv(xr), flv(xi)


@highest_precision
def pcholesky_lower(b, nb=128, block_kernel=True):
    """Planar Cholesky B = L L^H (left-looking, one nb-column block at a
    time).

    Returns (L, info) with info the 1-based global column index of the
    first non-positive pivot, 0 on success (cuSOLVER devInfo semantics,
    zhegvdx_gpu.F90:136-142), as an int32 0-d tensor.

    block_kernel (the JAX argument, fed from ``cfg.mosaic_kernels``): in
    fp32 every diagonal block goes to the Cholesky-block kernel K1
    (ops/pchol.py; any nb <= 128), which also returns inv(L_d), so the
    subdiagonal panel solve is one planar gemm (forward error
    eps32 * kappa(block), which the fp64 refinement absorbs). In fp64, or
    with ``block_kernel=False``, the block is factored by ``_pchol_base``
    and the panel solved by substitution.
    """
    br, bi = b
    n = br.shape[0]
    if n % nb != 0:
        raise ValueError(f"pcholesky requires n % nb == 0, got n={n}, nb={nb}")
    use_kernel = block_kernel and br.dtype == torch.float32
    lr = torch.zeros_like(br)
    li = torch.zeros_like(bi)
    fail = torch.zeros((), dtype=torch.int32, device=br.device)
    for k0 in range(0, n, nb):
        # panel = B[k0:, k-block] - L[k0:, :k0] @ L[k-block, :k0]^H
        lm_r, lm_i = lr[k0:, :k0], li[k0:, :k0]
        row_r, row_i = lr[k0 : k0 + nb, :k0], li[k0 : k0 + nb, :k0]
        pan_r = br[k0:, k0 : k0 + nb] - (lm_r @ row_r.T + lm_i @ row_i.T)
        pan_i = bi[k0:, k0 : k0 + nb] - (lm_i @ row_r.T - lm_r @ row_i.T)
        sub_r, sub_i = pan_r[nb:], pan_i[nb:]
        if use_kernel:
            ld_r, ld_i, inv_r, inv_i, blk_fail = pchol_block_planar(
                pan_r[:nb], pan_i[:nb]
            )
            # X L_d^H = sub  =>  X = sub @ inv(L_d)^H (one planar gemm)
            x_r = sub_r @ inv_r.T + sub_i @ inv_i.T
            x_i = sub_i @ inv_r.T - sub_r @ inv_i.T
        else:
            ld_r, ld_i, blk_fail = _pchol_base(pan_r[:nb], pan_i[:nb], nb)
            # X L_d^H = sub  <=>  L_d conj(X)^T = conj(sub)^T
            y_r, y_i = _fsub_base(ld_r, ld_i, sub_r.T, -sub_i.T, nb)
            x_r, x_i = y_r.T, -y_i.T
        # devInfo semantics: 1-based global column of the FIRST bad pivot
        fail = torch.where((fail == 0) & (blk_fail > 0), blk_fail + k0, fail)
        lr[k0 : k0 + nb, k0 : k0 + nb] = ld_r
        li[k0 : k0 + nb, k0 : k0 + nb] = ld_i
        lr[k0 + nb :, k0 : k0 + nb] = x_r
        li[k0 + nb :, k0 : k0 + nb] = x_i
    return (lr, li), fail.to(torch.int32)
