"""Batched cyclic Jacobi eigensolver for small symmetric blocks (twin of
eigensolver_gpu_tpu/ops/jacobi.py).

The fp64 leaf solver of the divide and conquer (ops/stedc.py), as in the
JAX package: Jacobi needs only +, *, /, sqrt, and each round applies m/2
disjoint plane rotations to the whole batch as one pair of batched gemms.

The rotation schedule is a static round-robin tournament (m-1 rounds of
m/2 disjoint pairs), so the solve is a fixed loop of sweeps * (m-1)
rounds with gather/scatter-built rotation matrices and no
data-dependent control flow.

``jacobi_eigh_planar`` (the Hermitian planar variant) is not ported yet;
it waits with ops/complex_embed.py, its only caller.
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
