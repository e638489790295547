"""Batched cyclic Jacobi eigensolver for small symmetric blocks (twin of
eigensolver_gpu_tpu/ops/jacobi.py).

The fp64 leaf solver of the divide and conquer (ops/stedc.py), as in the
JAX package: Jacobi needs only +, *, /, sqrt, and each round applies m/2
disjoint plane rotations to the whole batch as one pair of batched gemms.

The rotation schedule is a static round-robin tournament (m-1 rounds of
m/2 disjoint pairs), so the solve is a fixed loop of sweeps * (m-1)
rounds with gather/scatter-built rotation matrices and no
data-dependent control flow.

``jacobi_eigh_planar`` is the Hermitian variant in planar (re, im)
arithmetic, the Rayleigh-Ritz solver of ops/complex_embed.py: the same
schedule, skip test and rotation as the JAX function. Where the JAX
function forms each round's dense rotation G and applies it with planar
gemms (eight m x m products a round), the port applies the m/2 disjoint
rotations of a round to rows and columns p, q by gathers and scatters,
O(m^2) a round: the same function, one code path on the CPU and the card.
"""

from __future__ import annotations

import numpy as np
import torch

from eigensolver_gpu_torch.utils.precision import highest_precision


def _round_robin(m):
    """(rounds, m/2) index arrays p, q with p < q, disjoint within a round."""
    players = list(range(m))
    rounds_p, rounds_q = [], []
    for _ in range(m - 1):
        ps, qs = [], []
        for i in range(m // 2):
            x, y = players[i], players[m - 1 - i]
            ps.append(min(x, y))
            qs.append(max(x, y))
        rounds_p.append(ps)
        rounds_q.append(qs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.array(rounds_p, np.int64), np.array(rounds_q, np.int64)


@highest_precision
def jacobi_eigh(a, sweeps=10):
    """Eigendecomposition of a batch of small symmetric matrices.

    a: (..., m, m) real symmetric, m even. Returns (w ascending, v).
    """
    batch_shape = a.shape[:-2]
    m = a.shape[-1]
    if m % 2 != 0:
        raise ValueError(f"jacobi_eigh requires even m, got {m}")
    dt = a.dtype
    dev = a.device
    a = a.reshape((-1, m, m))
    p_np, q_np = _round_robin(m)
    p_all = torch.as_tensor(p_np, device=dev)
    q_all = torch.as_tensor(q_np, device=dev)
    rounds = m - 1
    eps = torch.finfo(dt).eps
    one = torch.ones((), dtype=dt, device=dev)
    eye = torch.eye(m, dtype=dt, device=dev).expand(a.shape[0], m, m)
    v = eye
    for r in range(sweeps * rounds):
        p = p_all[r % rounds]
        q = q_all[r % rounds]
        app = a[:, p, p]
        aqq = a[:, q, q]
        apq = a[:, p, q]
        # Golub & Van Loan 8.4.1 rotation that zeroes a[p,q]; rotations
        # whose off-diagonal is negligible relative to the diagonals are
        # skipped (the classical convergence test, which also bounds
        # |tau| <= 1/eps so the division cannot overflow)
        nz = apq.abs() > eps * (app.abs() + aqq.abs()) / 2
        tau = (aqq - app) / (2.0 * torch.where(nz, apq, one))
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0, one, t)  # sign(0) = 0 guard
        t = torch.where(nz, t, 0.0)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        g = eye.clone()
        g[:, p, p] = c
        g[:, q, q] = c
        g[:, p, q] = s
        g[:, q, p] = -s
        # A <- G^T A G, V <- V G: batched gemms
        a = g.transpose(1, 2) @ a @ g
        a = (a + a.transpose(1, 2)) / 2
        v = v @ g
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, 1, order)
    v = torch.gather(v, 2, order[:, None, :].expand(-1, m, -1))
    return w.reshape(batch_shape + (m,)), v.reshape(batch_shape + (m, m))



def _rotate(x, pq, g, dim):
    """The m/2 disjoint rotations of a round applied to the complex x along
    ``dim``: -1, the columns (x <- x G); -2, the rows (x <- G^H x). ``pq``
    is the round's p indices then its q indices; g = (c, s e), c real and
    s e complex, (..., m/2) each, with G[p, p] = G[q, q] = c,
    G[p, q] = s e, G[q, p] = -conj(s e)."""
    h = pq.shape[0] // 2
    c, se = (t.unsqueeze(-3 - dim) for t in g)  # along the pairs: (.., 1, m/2), (.., m/2, 1)
    if dim == -2:
        se = se.conj()  # the rows take G^H: conj(s e) where the columns take s e
    xpq = x.index_select(dim, pq)
    xp, xq = xpq.narrow(dim, 0, h), xpq.narrow(dim, h, h)
    out = torch.empty_like(xpq)
    new_p, new_q = out.narrow(dim, 0, h), out.narrow(dim, h, h)
    # p: c x_p - conj(s e) x_q; q: (s e) x_p + c x_q
    torch.mul(xp, c, out=new_p)
    new_p.addcmul_(xq, se.conj(), value=-1)
    torch.mul(xq, c, out=new_q)
    new_q.addcmul_(xp, se)
    x.index_copy_(dim, pq, out)


@highest_precision
def jacobi_eigh_planar(ar, ai, sweeps=12):
    """Eigendecomposition of small HERMITIAN matrices in planar (re, im)
    arithmetic (the JAX function's contract).

    ar, ai: (..., m, m) with A = ar + i*ai Hermitian, m even; leading axes
    a batch. Returns (w ascending (..., m), (vr, vi)) with A V = V diag(w),
    V unitary.

    Complex cyclic Jacobi: the (p, q) rotation is the unitary
    G[p,p]=G[q,q]=c, G[p,q]=s*e^{i phi}, G[q,p]=-s*e^{-i phi} with
    phi = arg(a_pq) and theta from the real Golub/Van Loan formula on
    (a_pp, a_qq, |a_pq|); degenerate eigenvalues need no special handling.
    Each round applies A <- G^H (A G), V <- V G to the rows and columns its
    pairs touch (see the module docstring; inside, A and V are held as one
    complex tensor [A; V], so that one column pass rotates both) and
    re-symmetrises A."""
    m = ar.shape[-1]
    if m % 2 != 0:
        raise ValueError(f"jacobi_eigh_planar requires even m, got {m}")
    dt, dev = ar.dtype, ar.device
    p_np, q_np = _round_robin(m)
    pq_all = torch.as_tensor(np.concatenate([p_np, q_np], axis=1), device=dev)
    rounds, h = m - 1, m // 2
    half_eps = torch.finfo(dt).eps / 2
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    eye = torch.eye(m, dtype=dt, device=dev).expand(ar.shape)
    # [A; V]: the rows of A, then those of V
    y = torch.complex(torch.cat([ar, eye], dim=-2), torch.cat([ai, torch.zeros_like(eye)], dim=-2))
    a = y[..., :m, :]
    herm = torch.empty_like(a)
    # each round in about 36 small ops, one kernel each on the card: JAX's
    # formulas for the rotation, with fused ops where they round alike
    # (scalings by 1/2 are exact) or within an ulp (1 + t^2 by addcmul, rsqrt)
    for r in range(sweeps * rounds):
        pq = pq_all[r % rounds]
        p, q = pq[:h], pq[h:]
        dpq = torch.diagonal(a, dim1=-2, dim2=-1).real.index_select(-1, pq)
        app, aqq = dpq[..., :h], dpq[..., h:]  # diagonals real (Hermitian)
        apq = a[..., p, q]
        mag = apq.abs()
        dabs = dpq.abs()
        nz = mag > (dabs[..., :h] + dabs[..., h:]) * half_eps  # eps (|a_pp| + |a_qq|) / 2
        safe_mag = torch.where(nz, mag, one)
        e = apq / safe_mag  # e^{i phi} where nz; elsewhere t = 0 below zeroes s e
        tau = torch.addcdiv(zero, aqq - app, safe_mag, value=0.5)  # never -0
        # t = sign(tau) / (|tau| + sqrt(1 + tau^2)), and 1 where tau = 0
        den = torch.addcmul(one, tau, tau).sqrt_().add_(tau.abs())
        t = torch.where(nz, torch.copysign(den.reciprocal_(), tau), zero)
        c = torch.addcmul(one, t, t).rsqrt_()
        g = (c, (t * c) * e)
        _rotate(y, pq, g, -1)  # A G and V G
        _rotate(a, pq, g, -2)  # G^H (A G)
        torch.mul(torch.add(a, a.mH, out=herm), 0.5, out=a)  # (A + A^H) / 2
    w = torch.diagonal(a, dim1=-2, dim2=-1).real
    order = torch.argsort(w, dim=-1, stable=True)
    v = torch.take_along_dim(y[..., m:, :], order[..., None, :], -1)
    return torch.take_along_dim(w, order, -1), (v.real.contiguous(), v.imag.contiguous())
