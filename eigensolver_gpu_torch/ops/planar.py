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
  * ``ptrinv_lower``          -- full inv(L) by bottom-up batched doubling
                                 (the ``'trinv'`` solve mode)

and the elementwise helpers ``pconj``, ``pT``, ``pH``, ``padd``,
``psub``, ``pscale``, ``pdiv``, ``to_planar`` and ``from_planar``.

A planar array is a ``(re, im)`` tuple of equal-shape real tensors. The
JAX package's fixed-shape tricks (masked full-width gemms, the 4-segment
bucketing of ``_chol_segments``, ``ptrinv_lower``'s loop of slices and
concatenations) exist for XLA's static shapes; eager PyTorch slices the
exact triangle, and takes the blocks of a level as views.

Every function takes a batch of problems on leading axes (the k-point
batches of ``zhegvdx_planar_batched``): ``...``-indexing, per-item
scalars as tensors of the batch shape.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.pchol import _pchol_base, pchol_block_planar
from eigensolver_gpu_torch.utils.precision import highest_precision


def pconj(x):
    """Elementwise complex conjugate."""
    return (x[0], -x[1])


def pT(x):
    """Transpose (of the last two axes), no conjugation."""
    return (x[0].mT, x[1].mT)


def pH(x):
    """Conjugate transpose (of the last two axes)."""
    return (x[0].mT, -x[1].mT)


def padd(x, y):
    return (x[0] + y[0], x[1] + y[1])


def psub(x, y):
    return (x[0] - y[0], x[1] - y[1])


def pscale(x, sr, si=0.0):
    """Multiply by a complex scalar sr + i si (numbers, or tensors that
    broadcast: one scalar an item of a batch)."""
    return (x[0] * sr - x[1] * si, x[0] * si + x[1] * sr)


def pdiv(x, y):
    """Elementwise complex division x / y (0 where y is 0)."""
    den = y[0] * y[0] + y[1] * y[1]
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return ((x[0] * y[0] + x[1] * y[1]) / safe, (x[1] * y[0] - x[0] * y[1]) / safe)


def to_planar(a):
    """Split a complex (or real) numpy array or tensor into a planar pair of
    tensors; real input gets a zero imaginary plane."""
    t = torch.as_tensor(a)
    if not t.is_complex():
        return t, torch.zeros_like(t)
    return t.real.contiguous(), t.imag.contiguous()


def from_planar(x):
    """The complex numpy array of a planar pair (on the host)."""
    return x[0].detach().cpu().numpy() + 1j * x[1].detach().cpu().numpy()


def pmatmul(x, y):
    """Karatsuba complex product: 3 real gemms instead of 4."""
    m1 = x[0] @ y[0]
    m2 = x[1] @ y[1]
    m3 = (x[0] + x[1]) @ (y[0] + y[1])
    return (m1 - m2, m3 - m1 - m2)


def pmatmul_chunked(x, y, chunk):
    """pmatmul with the columns of y taken ``chunk`` at a time, so only
    one chunk's temporaries are alive at once."""
    m = y[0].shape[-1]
    if chunk is None or chunk >= m or m % chunk != 0:
        return pmatmul(x, y)
    parts = [pmatmul(x, (y[0][..., c : c + chunk], y[1][..., c : c + chunk]))
             for c in range(0, m, chunk)]
    return (torch.cat([p[0] for p in parts], -1), torch.cat([p[1] for p in parts], -1))


def _vm(row, mat):
    """row @ mat for a vector and a matrix, or for batches of each."""
    return row @ mat if row.dim() == 1 else (row[..., None, :] @ mat)[..., 0, :]


def _fsub_base(lr, li, br, bi, nb):
    """Forward substitution for the nb x nb planar lower block L X = B
    (or a batch of them: leading axes)."""
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    for i in range(nb):
        lrow_r, lrow_i = lr[..., i, :i], li[..., i, :i]
        acc_r = _vm(lrow_r, xr[..., :i, :]) - _vm(lrow_i, xi[..., :i, :])
        acc_i = _vm(lrow_r, xi[..., :i, :]) + _vm(lrow_i, xr[..., :i, :])
        num_r = br[..., i, :] - acc_r
        num_i = bi[..., i, :] - acc_i
        dr = lr[..., i, i, None]
        di = li[..., i, i, None]
        den = dr * dr + di * di
        safe = torch.where(den == 0, torch.ones_like(den), den)
        xr[..., i, :] = (num_r * dr + num_i * di) / safe
        xi[..., i, :] = (num_i * dr - num_r * di) / safe
    return xr, xi


def _ptrinv_batched(lr, li, base=16):
    """Batched inverse of planar lower-triangular blocks (..., k, k) by
    recursive block inversion inv([[A,0],[C,D]]) = [[iA,0],[-iD C iA, iD]]:
    sequential depth base + log2(k/base) instead of k rows."""
    k = lr.shape[-1]
    if k <= base:
        xr = torch.zeros_like(lr)
        xi = torch.zeros_like(li)
        eye = torch.eye(k, dtype=lr.dtype, device=lr.device)
        for i in range(k):
            lrow_r = lr[..., i, :i].unsqueeze(-2)
            lrow_i = li[..., i, :i].unsqueeze(-2)
            acc_r = (lrow_r @ xr[..., :i, :] - lrow_i @ xi[..., :i, :]).squeeze(-2)
            acc_i = (lrow_r @ xi[..., :i, :] + lrow_i @ xr[..., :i, :]).squeeze(-2)
            rhs_r = eye[i] - acc_r
            rhs_i = -acc_i
            dr = lr[..., i, i, None]
            di = li[..., i, i, None]
            den = dr * dr + di * di
            safe = torch.where(den == 0, torch.ones_like(den), den)
            xr[..., i, :] = (rhs_r * dr + rhs_i * di) / safe
            xi[..., i, :] = (rhs_i * dr - rhs_r * di) / safe
        return xr, xi
    h = k // 2
    ia_r, ia_i = _ptrinv_batched(lr[..., :h, :h], li[..., :h, :h], base)
    id_r, id_i = _ptrinv_batched(lr[..., h:, h:], li[..., h:, h:], base)
    cr, ci = lr[..., h:, :h], li[..., h:, :h]
    t_r = cr @ ia_r - ci @ ia_i
    t_i = cr @ ia_i + ci @ ia_r
    m_r = id_r @ t_r - id_i @ t_i
    m_i = id_r @ t_i + id_i @ t_r
    out_r = torch.zeros_like(lr)
    out_i = torch.zeros_like(li)
    out_r[..., :h, :h], out_i[..., :h, :h] = ia_r, ia_i
    out_r[..., h:, :h], out_i[..., h:, :h] = -m_r, -m_i
    out_r[..., h:, h:], out_i[..., h:, h:] = id_r, id_i
    return out_r, out_i


def _diag_blocks(x, nb):
    """(..., n/nb, nb, nb) stack of the diagonal blocks of x (..., n, n)."""
    n = x.shape[-1]
    return torch.stack([x[..., k : k + nb, k : k + nb] for k in range(0, n, nb)], -3)


def _pmm4(x, y):
    """Planar product with four real gemms (the JAX twin's form in the
    inverse's doubling steps)."""
    return (x[0] @ y[0] - x[1] @ y[1], x[0] @ y[1] + x[1] @ y[0])


@highest_precision
def ptrinv_lower(l, base=128):
    """Full planar lower-triangular inverse by bottom-up batched doubling.

    Level 0 inverts all n/base diagonal blocks together
    (``_ptrinv_batched``); each further level merges neighbouring pairs by
    inv([[A,0],[C,D]]) = [[iA,0],[-iD C iA, iD]], all pairs of a level in
    one batched product, so a triangular solve against any right-hand side
    becomes one planar gemm. The blocks of a level are views of L and of
    the previous level's inverses (reshapes, no copies). Forward error
    ~eps * kappa(L) (an explicit inverse): the fp32 pipeline's choice,
    which the fp64 refinement absorbs. Leading axes are a batch of
    problems. Raises ValueError unless n = base * 2^k.
    """
    lr, li = l
    n = lr.shape[-1]
    if n % base != 0 or (n // base) & (n // base - 1):
        raise ValueError(f"ptrinv requires n = base * 2^k, got n={n}, base={base}")
    lead = lr.shape[:-2]
    inv = _ptrinv_batched(_diag_blocks(lr, base), _diag_blocks(li, base))  # (..., n/base, b, b)
    size = base
    while size < n:
        pairs = n // (2 * size)

        def lower_left(x):
            # the (pairs, size, size) blocks x[(2p+1)s:(2p+2)s, 2ps:(2p+1)s]
            x6 = x.reshape(lead + (pairs, 2, size, pairs, 2, size))[..., :, 1, :, :, 0, :]
            return torch.diagonal(x6, dim1=-4, dim2=-2).movedim(-1, -3)

        ia = (inv[0][..., 0::2, :, :], inv[1][..., 0::2, :, :])
        id_ = (inv[0][..., 1::2, :, :], inv[1][..., 1::2, :, :])
        m = _pmm4(id_, _pmm4((lower_left(lr), lower_left(li)), ia))  # M = iD C iA
        new = []
        for a_, d_, m_ in zip(ia, id_, m):
            out = torch.zeros(lead + (pairs, 2, size, 2, size), dtype=a_.dtype, device=a_.device)
            out[..., 0, :, 0, :] = a_
            out[..., 1, :, 0, :] = -m_
            out[..., 1, :, 1, :] = d_
            new.append(out.reshape(lead + (pairs, 2 * size, 2 * size)))
        inv = tuple(new)
        size *= 2
    return inv[0][..., 0, :, :], inv[1][..., 0, :, :]


@highest_precision
def ptrsm_left_lower_inv(l, b, nb=128):
    """L X = B via batched-inverted diagonal blocks + blocked forward
    substitution: n/nb sequential steps. Forward error ~eps * kappa of
    the diagonal blocks -- the fp32 pipeline's choice, which the fp64
    refinement absorbs; the fp64 path keeps pure substitution. Leading
    axes of l and b are a batch of problems."""
    lr, li = l
    br, bi = b
    n = lr.shape[-1]
    if n % nb != 0:
        raise ValueError(f"ptrsm requires n % nb == 0, got n={n}, nb={nb}")
    inv_r, inv_i = _ptrinv_batched(_diag_blocks(lr, nb), _diag_blocks(li, nb))
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    for k, k0 in enumerate(range(0, n, nb)):
        rows = slice(k0, k0 + nb)
        lrow = (lr[..., rows, :k0], li[..., rows, :k0])
        acc_r = lrow[0] @ xr[..., :k0, :] - lrow[1] @ xi[..., :k0, :]
        acc_i = lrow[0] @ xi[..., :k0, :] + lrow[1] @ xr[..., :k0, :]
        rhs_r = br[..., rows, :] - acc_r
        rhs_i = bi[..., rows, :] - acc_i
        ik_r, ik_i = inv_r[..., k, :, :], inv_i[..., k, :, :]
        xr[..., rows, :] = ik_r @ rhs_r - ik_i @ rhs_i
        xi[..., rows, :] = ik_r @ rhs_i + ik_i @ rhs_r
    return xr, xi


@highest_precision
def ptrsm_left_lower(l, b, nb=128):
    """Solve L X = B with planar lower-triangular L (n x n), B (n x m):
    blocked forward substitution with nb-row substitution on each
    diagonal block. Leading axes are a batch of problems."""
    lr, li = l
    br, bi = b
    n = lr.shape[-1]
    if n % nb != 0:
        raise ValueError(f"ptrsm requires n % nb == 0, got n={n}, nb={nb}")
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    for k0 in range(0, n, nb):
        rows = slice(k0, k0 + nb)
        acc_r = lr[..., rows, :k0] @ xr[..., :k0, :] - li[..., rows, :k0] @ xi[..., :k0, :]
        acc_i = lr[..., rows, :k0] @ xi[..., :k0, :] + li[..., rows, :k0] @ xr[..., :k0, :]
        xr[..., rows, :], xi[..., rows, :] = _fsub_base(
            lr[..., rows, rows], li[..., rows, rows],
            br[..., rows, :] - acc_r, bi[..., rows, :] - acc_i, nb,
        )
    return xr, xi


def ptrsm_left_upper(u, b, nb=128, solve_lower=ptrsm_left_lower):
    """Solve U X = B with planar upper-triangular U via the flip identity
    (P U P is lower triangular for the reversal permutation P), using
    ``solve_lower`` (``ptrsm_left_lower`` or ``ptrsm_left_lower_inv``)
    on the flipped system."""
    fl = lambda m: torch.flip(m, (-2, -1))
    flv = lambda m: torch.flip(m, (-2,))
    xr, xi = solve_lower((fl(u[0]), fl(u[1])), (flv(b[0]), flv(b[1])), nb=nb)
    return flv(xr), flv(xi)


@highest_precision
def pcholesky_lower(b, nb=128, block_kernel=True):
    """Planar Cholesky B = L L^H (left-looking, one nb-column block at a
    time).

    Returns (L, info) with info the 1-based global column index of the
    first non-positive pivot, 0 on success (cuSOLVER devInfo semantics,
    zhegvdx_gpu.F90:136-142), as an int32 0-d tensor. Leading axes of b
    are a batch of problems: info is then one entry an item, and each
    block step is one K1 launch for the whole batch.

    block_kernel (the JAX argument, fed from ``cfg.mosaic_kernels``): in
    fp32 every diagonal block goes to the Cholesky-block kernel K1
    (ops/pchol.py; any nb <= 128), which also returns inv(L_d), so the
    subdiagonal panel solve is one planar gemm (forward error
    eps32 * kappa(block), which the fp64 refinement absorbs). In fp64, or
    with ``block_kernel=False``, the block is factored by ``_pchol_base``
    and the panel solved by substitution.
    """
    br, bi = b
    n = br.shape[-1]
    if n % nb != 0:
        raise ValueError(f"pcholesky requires n % nb == 0, got n={n}, nb={nb}")
    use_kernel = block_kernel and br.dtype == torch.float32
    lr = torch.zeros_like(br)
    li = torch.zeros_like(bi)
    fail = torch.zeros(br.shape[:-2], dtype=torch.int32, device=br.device)
    for k0 in range(0, n, nb):
        # panel = B[k0:, k-block] - L[k0:, :k0] @ L[k-block, :k0]^H
        lm_r, lm_i = lr[..., k0:, :k0], li[..., k0:, :k0]
        row_r, row_i = lr[..., k0 : k0 + nb, :k0], li[..., k0 : k0 + nb, :k0]
        pan_r = br[..., k0:, k0 : k0 + nb] - (lm_r @ row_r.mT + lm_i @ row_i.mT)
        pan_i = bi[..., k0:, k0 : k0 + nb] - (lm_i @ row_r.mT - lm_r @ row_i.mT)
        sub_r, sub_i = pan_r[..., nb:, :], pan_i[..., nb:, :]
        if use_kernel:
            # one launch for the whole batch at this block step
            ld_r, ld_i, inv_r, inv_i, blk_fail = pchol_block_planar(
                pan_r[..., :nb, :], pan_i[..., :nb, :]
            )
            # X L_d^H = sub  =>  X = sub @ inv(L_d)^H (one planar gemm)
            x_r = sub_r @ inv_r.mT + sub_i @ inv_i.mT
            x_i = sub_i @ inv_r.mT - sub_r @ inv_i.mT
        else:
            ld_r, ld_i, blk_fail = _pchol_base(pan_r[..., :nb, :], pan_i[..., :nb, :], nb)
            # X L_d^H = sub  <=>  L_d conj(X)^T = conj(sub)^T
            y_r, y_i = _fsub_base(ld_r, ld_i, sub_r.mT, -sub_i.mT, nb)
            x_r, x_i = y_r.mT, -y_i.mT
        # devInfo semantics: 1-based global column of the FIRST bad pivot
        fail = torch.where((fail == 0) & (blk_fail > 0), blk_fail + k0, fail)
        lr[..., k0 : k0 + nb, k0 : k0 + nb] = ld_r
        li[..., k0 : k0 + nb, k0 : k0 + nb] = ld_i
        lr[..., k0 + nb :, k0 : k0 + nb] = x_r
        li[..., k0 + nb :, k0 : k0 + nb] = x_i
    return (lr, li), fail.to(torch.int32)
