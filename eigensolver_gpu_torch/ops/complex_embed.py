"""Hermitian problems through their real embedding (twin of
eigensolver_gpu_tpu/ops/complex_embed.py).

For Hermitian ``A = Ar + i Ai``,

    M(A) = [[Ar, -Ai],
            [Ai,  Ar]]        (2n x 2n, real symmetric)

has the same spectrum as A with every eigenvalue doubled; a real
eigenvector [u; v] of M maps to the complex eigenvector x = u + i v. B HPD
embeds to M(B) SPD, so ``A x = lambda B x`` becomes the real generalized
problem ``M(A) y = lambda M(B) y``, solved by the real pipeline
(models/sygvdx.py) at twice the flops of complex arithmetic. In fp64 at
2n >= ``two_stage_min_n`` that is the two-stage reduction (kernels K5, K7,
K9), one batched solve for a batch (``zhegvdx_embedded_batched``).

Pair selection (structure-preserving): eigenvalues come out in adjacent
equal pairs, and the real solver is free to return any rotation of a
degenerate eigenspace, so picking every other column can give linearly
dependent complex vectors. The extraction never picks: all 2m selected
real columns are mapped to complex vectors X (n, 2m) whose complex span is
the m-dimensional invariant subspace; a fixed random compression X Omega
(the JAX package's Omega, drawn from the same seed), a planar Cholesky-QR
B-orthonormalization and a Rayleigh-Ritz projection (planar complex
Jacobi, ops/jacobi.jacobi_eigh_planar, degeneracy-safe) return
B-orthonormal eigenpairs of the original pencil.

The JAX package needs this route because its TPU stack has no complex
dtype; the port keeps it with the same contracts, so that a complex
k-point batch can run on the batched real two-stage pipeline. Every
function takes leading batch axes where the JAX function is vmapped: the
batched entry solves the batch's embeddings as one batched real solve and
extracts every item in the same batched products.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eigensolver_gpu_torch.models.sygvdx import sygvdx
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range

OMEGA_SEED = 20240817  # the JAX package's compression seed


class EmbeddedResult(NamedTuple):
    w: torch.Tensor  # (m,) eigenvalues
    zr: torch.Tensor  # (n, m) real part of eigenvectors
    zi: torch.Tensor  # (n, m) imaginary part
    info: torch.Tensor  # 0 ok; 1..n: B pivot (cuSOLVER semantics); > n:
    # the extraction's compression gram went (near-)rank-deficient at
    # column info - n -- the returned basis is degraded, re-draw Omega


def embed_herm(ar, ai):
    """[[Ar, -Ai], [Ai, Ar]] for Hermitian A = Ar + i Ai (leading axes a
    batch)."""
    return torch.cat([torch.cat([ar, -ai], dim=-1), torch.cat([ai, ar], dim=-1)], dim=-2)


def _embedded(ar, ai, br, bi, il, iu, cfg, solve):
    """The body of both entries: ``solve`` is the real generalized solve of
    the embeddings (``sygvdx`` or the batched one)."""
    n = ar.shape[-1]
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"need 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
    # complex indices il..iu = doubled real indices 2il-1 .. 2iu (1-based)
    _, y, info = solve(embed_herm(ar, ai), embed_herm(br, bi), il=2 * il - 1, iu=2 * iu,
                       cfg=cfg)
    w, zr, zi, xfail = _extract_invariant(y, (ar, ai), (br, bi), iu - il + 1)
    # rank-deficient compression (xfail > 0) is reported as info = n +
    # failing gram column, distinguishable from B's 1..n pivot indices; an
    # earlier Cholesky failure keeps priority
    info = torch.where((info == 0) & (xfail > 0), n + xfail, info).to(torch.int32)
    return EmbeddedResult(w=w, zr=zr, zi=zi, info=info)


@highest_precision
def zhegvdx_embedded(ar, ai, br, bi, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Complex generalized solve via the real embedding.

    Args are the real and imaginary parts of A and B ((n, n) real tensors,
    so the whole computation stays in real dtypes end to end), on the
    device they are solved on."""
    n = ar.shape[-1]
    if any(x.shape != (n, n) for x in (ar, ai, br, bi)):
        raise ValueError("zhegvdx_embedded takes four (n, n) planes of one shape, got "
                         f"{[tuple(x.shape) for x in (ar, ai, br, bi)]}")
    with trace_range("zhegvdx_embedded"):
        return _embedded(ar, ai, br, bi, il, iu, cfg, sygvdx)


def _omega(m, dtype, device):
    """The fixed compression (2m, m) planes, drawn as the JAX package draws
    them, so that both packages compress with the same matrix."""
    host = np.random.default_rng(OMEGA_SEED)
    om_r = host.standard_normal((2 * m, m))
    om_i = host.standard_normal((2 * m, m))
    return (torch.as_tensor(om_r, dtype=dtype, device=device),
            torch.as_tensor(om_i, dtype=dtype, device=device))


def _extract_invariant(y, a, b, m):
    """Structure-preserving extraction of m complex eigenpairs from the 2m
    selected real embedded eigenvectors y (..., 2n, 2m) (module docstring):
    random J-compression -> planar Cholesky-QR in the B metric ->
    Rayleigh-Ritz with the planar complex Jacobi. Exact for degenerate
    spectra. Returns (w, zr, zi, gfail), gfail the 1-based gram column of
    the first clamped pivot (0 if none), per item."""
    from eigensolver_gpu_torch.ops.jacobi import jacobi_eigh_planar
    from eigensolver_gpu_torch.ops.pchol import _pchol_base
    from eigensolver_gpu_torch.ops.planar import _fsub_base, pH, pmatmul

    ar, ai = a
    n = ar.shape[-1]
    dt = ar.dtype
    with trace_range("extract_invariant"):
        xr = y[..., :n, :].to(dt)  # complex columns x_j = u_j + i v_j
        xi = y[..., n:, :].to(dt)
        om_r, om_i = _omega(m, dt, ar.device)
        xh = (xr @ om_r - xi @ om_i, xr @ om_i + xi @ om_r)  # (..., n, m)
        # B-orthonormalize: G = Xh^H B Xh = L L^H; Q = Xh L^{-H}
        g = pmatmul(pH(xh), pmatmul(b, xh))
        gr = (g[0] + g[0].mT) / 2
        gi = (g[1] - g[1].mT) / 2
        lr, li, gfail = _pchol_base(gr, gi, m)
        # Q^H = L^{-1} Xh^H (planar forward substitution), Q = (Q^H)^H
        qh = _fsub_base(lr, li, xh[0].mT, -xh[1].mT, m)
        q = (qh[0].mT, -qh[1].mT)
        # Rayleigh-Ritz: S = Q^H A Q is exact on the invariant subspace
        s = pmatmul(pH(q), pmatmul(a, q))
        sr = (s[0] + s[0].mT) / 2
        si = (s[1] - s[1].mT) / 2
        if m % 2 != 0:
            # pad with a decoupled above-spectrum value (the round-robin
            # schedule of the planar Jacobi needs an even size)
            bound = torch.amax(torch.sum(sr.abs() + si.abs(), dim=-1), dim=-1) + 1.0
            sr = torch.nn.functional.pad(sr, (0, 1, 0, 1))
            si = torch.nn.functional.pad(si, (0, 1, 0, 1))
            sr[..., m, m] = bound
        w, (rr, ri) = jacobi_eigh_planar(sr, si)
        w = w[..., :m]
        rr = rr[..., :m, :m]
        ri = ri[..., :m, :m]
        zr = q[0] @ rr - q[1] @ ri
        zi = q[0] @ ri + q[1] @ rr
    return w, zr, zi, gfail


@highest_precision
def zhegvdx_embedded_batched(ar, ai, br, bi, il=1, iu=None,
                             cfg: SolverConfig = DEFAULT_CONFIG):
    """The embedded solve of a batch (QE k-points; the JAX function is a
    vmap of ``zhegvdx_embedded``): (batch, n, n) planes in, an
    EmbeddedResult with a leading batch axis out. One batched real solve
    of the (batch, 2n, 2n) embeddings (``sygvdx_batched``: where the
    two-stage reduction engages, one launch of K5 a panel and one of K7
    and K9 for the batch), then one batched extraction."""
    from eigensolver_gpu_torch.parallel.sharded import sygvdx_batched

    if ar.dim() != 3 or any(x.shape != ar.shape for x in (ai, br, bi)) \
            or ar.shape[-1] != ar.shape[-2]:
        raise ValueError("zhegvdx_embedded_batched takes four (batch, n, n) planes of one "
                         f"shape, got {[tuple(x.shape) for x in (ar, ai, br, bi)]}")
    with trace_range("zhegvdx_embedded_batched"):
        return _embedded(ar, ai, br, bi, il, iu, cfg, sygvdx_batched)


def zhegvdx_via_embedding(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG,
                          device="cuda"):
    """Convenience wrapper taking complex numpy arrays on the host: their
    planes go to ``device`` (the card by default), in float64 for
    complex128 input and float32 otherwise."""
    a = np.asarray(a)
    b = np.asarray(b)
    rdt = torch.float64 if a.dtype == np.complex128 else torch.float32
    planes = (torch.as_tensor(np.ascontiguousarray(x), dtype=rdt).to(device)
              for x in (a.real, a.imag, b.real, b.imag))
    return zhegvdx_embedded(*planes, il=il, iu=iu, cfg=cfg)
