"""Blocked triangular solves with batched-inverted diagonal blocks (twin
of eigensolver_gpu_tpu/ops/trsm.py; the real/complex dtype twin of
ops/planar.ptrsm_left_lower_inv).

Phase 4 of the generalized driver back-substitutes x = U^{-1} y
(reference: one cublas trsm, zhegvdx_gpu.F90:169). On the fp32 pipeline
this module replaces the whole-matrix solve with the scheme of the
planar stack:

  * all n/nb diagonal blocks are inverted together -- a 16-wide batched
    substitution + log2(nb/16) batched-gemm doubling levels;
  * back-substitution then runs in n/nb sequential steps whose
    correction is a plain gemm on exact slices.

Forward error is ~eps * kappa(U_block) (explicit-inverse apply) instead
of pure substitution's eps * kappa(U): acceptable only where the fp64
refinement absorbs it, so the drivers gate this to their fp32 inner
pipelines. The fp64 path keeps ``torch.linalg.solve_triangular``.
Every solve takes a batch of problems on leading axes.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.utils.precision import highest_precision


def _diag_blocks(x, nb):
    """(..., n/nb, nb, nb) stack of the diagonal blocks of x (..., n, n)."""
    return torch.stack([x[..., k : k + nb, k : k + nb] for k in range(0, x.shape[-1], nb)], -3)


def _merge_pairs(ia, idd, c):
    """inv([[A, 0], [C, D]]) = [[iA, 0], [-iD C iA, iD]], batched."""
    m = idd @ c @ ia
    z = torch.zeros_like(m)
    return torch.cat([torch.cat([ia, z], -1), torch.cat([-m, idd], -1)], -2)


def _trinv_lower_batched(l, base=16):
    """Invert a batch of lower-triangular blocks (k, nb, nb).

    Level 0: one ``base``-step substitution loop inverts every
    base x base diagonal sub-block of every batch entry at once; then
    log2(nb/base) batched-gemm doubling levels merge pairs.
    """
    k, nb, _ = l.shape
    if nb % base or (nb // base) & (nb // base - 1):
        raise ValueError(f"trinv requires nb = base * 2^j, got nb={nb}")
    nsub = nb // base
    sub = torch.stack(
        [l[:, i : i + base, i : i + base] for i in range(0, nb, base)], 1
    ).reshape(k * nsub, base, base)
    eye = torch.eye(base, dtype=l.dtype, device=l.device)
    dinv = 1.0 / torch.diagonal(sub, dim1=1, dim2=2)
    inv = torch.zeros_like(sub)
    for i in range(base):
        # row i of inv: (e_i - L[i,:i] @ x[:i]) / L[i,i], batched
        acc = (sub[:, i : i + 1, :i] @ inv[:, :i]).squeeze(1)
        inv[:, i] = (eye[i] - acc) * dinv[:, i, None]
    size = base
    while size < nb:
        pairs = nb // (2 * size)
        inv = inv.reshape(k * pairs, 2, size, size)
        # C blocks: rows [size, 2*size), cols [0, size) of each pair
        c = torch.stack(
            [l[:, p + size : p + 2 * size, p : p + size] for p in range(0, nb, 2 * size)], 1
        ).reshape(k * pairs, size, size)
        inv = _merge_pairs(inv[:, 0], inv[:, 1], c)
        size *= 2
    return inv.reshape(k, nb, nb)


def upper_block_inverses(u, nb):
    """Batched inverses of U's nb x nb diagonal blocks (upper), shape
    (..., n/nb, nb, nb) for U (..., n, n)."""
    blocks = _diag_blocks(u, nb).mT
    inv = _trinv_lower_batched(blocks.reshape((-1,) + blocks.shape[-2:]))
    return inv.reshape(blocks.shape).mT


def _check_blocks(n, nb, what):
    if n % nb != 0:
        raise ValueError(f"{what} requires n % nb == 0, got {n} % {nb}")


@highest_precision
def trsm_left_upper_inv(u, b, nb=512):
    """Solve U X = B (U upper triangular, B (n, m)) via batched-inverted
    diagonal blocks + blocked back-substitution: n/nb sequential steps,
    each one correction gemm + one small block gemm.

    fp32-pipeline use only (see the module docstring); requires
    n % nb == 0 and nb a power-of-two multiple of 16 -- callers fall back
    to ``torch.linalg.solve_triangular`` otherwise.
    """
    n = u.shape[-1]
    _check_blocks(n, nb, "trsm_left_upper_inv")
    inv = upper_block_inverses(u, nb)
    x = torch.zeros_like(b)
    for k in range(n // nb - 1, -1, -1):
        k0, k1 = k * nb, k * nb + nb
        rhs = b[..., k0:k1, :]
        if k1 < n:
            rhs = rhs - u[..., k0:k1, k1:] @ x[..., k1:, :]  # solved rows only
        x[..., k0:k1, :] = inv[..., k, :, :] @ rhs
    return x


@highest_precision
def trinv_upper_full(u, base=512):
    """Full upper-triangular inverse by bottom-up batched block doubling.

    Level 0 inverts all n/base diagonal blocks together; each of the
    log2(n/base) merge levels is a pair of batched gemms on the
    transposed (lower) view.

    Forward error ~eps * kappa(U) (explicit full inverse): strictly for
    fp32 pipelines whose fp64 refinement absorbs it. Requires
    n = base * 2^k."""
    n = u.shape[-1]
    if n % base != 0 or (n // base) & (n // base - 1):
        raise ValueError(f"trinv_upper_full requires n = base * 2^k, got {n}")
    l = u.mT  # lower view; inv(U) = inv(L)^T (transpose, no conjugation)
    blocks = _diag_blocks(l, base)
    inv = _trinv_lower_batched(blocks.reshape((-1,) + blocks.shape[-2:])).reshape(blocks.shape)
    size = base
    while size < n:
        c = torch.stack(
            [l[..., p + size : p + 2 * size, p : p + size] for p in range(0, n, 2 * size)], -3
        )
        inv = _merge_pairs(inv[..., 0::2, :, :], inv[..., 1::2, :, :], c)
        size *= 2
    return inv[..., 0, :, :].mT


@highest_precision
def trsm_left_upper_trans_inv(u, b, nb=512):
    """Solve U^H X = B (forward substitution over row blocks; same scheme
    and caveats as trsm_left_upper_inv). Block row k's correction reads
    U[:k0, k0:k1]^H against the already-solved X[:k0]."""
    n = u.shape[-1]
    _check_blocks(n, nb, "trsm_left_upper_trans_inv")
    inv = upper_block_inverses(u, nb)
    x = torch.zeros_like(b)
    for k in range(n // nb):
        k0, k1 = k * nb, k * nb + nb
        rhs = b[..., k0:k1, :]
        if k0 > 0:
            rhs = rhs - u[..., :k0, k0:k1].mH @ x[..., :k0, :]
        x[..., k0:k1, :] = inv[..., k, :, :].mH @ rhs
    return x


@highest_precision
def trsm_right_upper_inv(u, b, nb=512):
    """Solve X U = B (column blocks left to right; same scheme and
    caveats as trsm_left_upper_inv)."""
    n = u.shape[-1]
    _check_blocks(n, nb, "trsm_right_upper_inv")
    inv = upper_block_inverses(u, nb)
    x = torch.zeros_like(b)
    for k in range(n // nb):
        k0, k1 = k * nb, k * nb + nb
        rhs = b[..., k0:k1]
        if k0 > 0:
            rhs = rhs - x[..., :k0] @ u[..., :k0, k0:k1]
        x[..., k0:k1] = rhs @ inv[..., k, :, :]
    return x


def trsm_phase4(u, y, nb=512):
    """Driver-facing phase-4 back-substitution x = U^{-1} y.

    Picks the inverse-diagonal blocked scheme on fp32/complex64 inputs
    with compatible shapes (the mixed pipelines, where refinement absorbs
    the explicit-inverse forward error) and exact substitution everywhere
    else (the fp64 contract path).
    """
    n = u.shape[-1]
    lowprec = u.dtype in (torch.float32, torch.complex64)
    if lowprec and n % nb == 0 and n // nb >= 2:
        return trsm_left_upper_inv(u, y, nb=nb)
    return torch.linalg.solve_triangular(u, y, upper=True)
