"""On-device divide-and-conquer symmetric tridiagonal eigensolver (twin of
eigensolver_gpu_tpu/ops/stedc.py).

Replaces the reference's CPU escape hatch (dsyevd_gpu.F90:99: the
tridiagonal goes to the host for LAPACK dstedc). The merge tree runs on
the device: leaves are batched dense eighs, each level merges all its
pairs at once along a leading batch dimension (the JAX package's vmap),
the secular equation is solved for every root together by a
safeguarded rational iteration, and the eigenvectors are assembled with
one gemm per merge.

Design decisions carried over from the JAX package (see its docstring):
deflation by masking, separation of surviving poles to a minimum gap
instead of dlaed2's Givens chain, and the Gu/Eisenstat recomputed z.

Port differences:
  * the secular iteration runs the fixed ``_secular_iters`` count (35 in
    fp32, 60 in fp64) instead of a while loop: converged lanes freeze,
    and no step reads a device value on the host;
  * the deflation-aware bucketed assembly (``compact``) and the mesh
    sharding are not ported; every merge runs the full assembly gemm;
  * leaves follow the JAX rule: torch.linalg.eigh in fp32 (the JAX 'xla'
    leaf), the batched cyclic Jacobi of ops/jacobi.py in fp64 (for an
    even leaf size, else dense eigh).

Input: d (n,), e (n-1,) real. Output: (w, q) with w ascending and q
orthogonal, T q = q diag(w), T = tridiag(e, d, e).
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.jacobi import jacobi_eigh
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _secular_iters(dt):
    """Safeguarded-iteration count: worst-case lanes degrade to bisection,
    so the count must bottom out the dtype's precision."""
    return 60 if dt == torch.float64 else 35


def _merge_pair(d1, q1, d2, q2, beta, gap_scale):
    """Merge batches of solved blocks coupled by off-diagonal ``beta``.

    d1 (B, m), q1 (B, m, m), d2 (B, m2), q2 (B, m2, m2), beta (B,):
    [[T1, beta e e^T], [.., T2]] = blockdiag(D1, D2) + rho v v^T with
    rho = |beta| (the diagonal adjustments were applied on the way down,
    in stedc()). Returns (w (B, m+m2) ascending, q (B, m+m2, m+m2))."""
    bsz, m = d1.shape
    n2 = m + d2.shape[1]
    dt = d1.dtype
    dev = d1.device
    eps = torch.finfo(dt).eps
    one = torch.ones((), dtype=dt, device=dev)

    rho = beta.abs()[:, None]
    s = torch.where(beta >= 0, one, -one)[:, None]
    z = torch.cat([s * q1[:, -1, :], q2[:, 0, :]], dim=1)
    d = torch.cat([d1, d2], dim=1)

    # sort poles ascending; remember the permutation for the assembly
    perm = torch.argsort(d, dim=1, stable=True)
    ds = torch.gather(d, 1, perm)
    zs = torch.gather(z, 1, perm)

    # --- deflation by masking (dlaed2's tiny-z test) ---
    big_z = (rho * zs.abs()).amax(dim=1, keepdim=True)
    tol = 8.0 * eps * torch.maximum(ds.abs().amax(dim=1, keepdim=True), big_z)
    alive = rho * zs.abs() > tol
    zs = torch.where(alive, zs, 0.0)
    z2 = zs * zs
    af = alive.to(dt)

    # --- separate surviving poles to a minimum gap ---
    gap_min = 16.0 * eps * gap_scale
    rank = torch.cumsum(af, dim=1) - af
    neg_big = ds.amin(dim=1, keepdim=True) - 2.0 * gap_scale - 1.0
    shifted = torch.where(alive, ds - rank * gap_min, neg_big)
    dsep = torch.cummax(shifted, dim=1).values + rank * gap_min
    dp = torch.where(alive, torch.maximum(ds, dsep), ds)

    # --- per-root search intervals ---
    idx = torch.arange(n2, device=dev).expand(bsz, n2)
    nxt_pos = torch.where(alive, idx, n2)
    nxt_pos = torch.flip(torch.cummin(torch.flip(nxt_pos, (1,)), dim=1).values, (1,))
    nxt_above = torch.cat([nxt_pos[:, 1:], torch.full((bsz, 1), n2, device=dev)], 1)
    zsum = rho * z2.sum(dim=1, keepdim=True)
    ub = dp.amax(dim=1, keepdim=True) + zsum + gap_min
    nxt_d = torch.where(
        nxt_above < n2, torch.gather(dp, 1, nxt_above.clamp_max(n2 - 1)), ub
    )

    # --- secular solve: all roots at once, shifted coordinates ---
    pd = dp[:, None, :] - dp[:, :, None]  # pd[b, i, j] = dp[j] - dp[i]
    gap = nxt_d - dp
    le_mask = torch.ones((n2, n2), dtype=torch.bool, device=dev).tril()

    def secular_parts(mu, sig_right):
        base = torch.where(sig_right[:, :, None], pd - gap[:, :, None], pd)
        delta = base - mu[:, :, None]
        safe = torch.where(delta == 0, one, delta)
        terms = z2[:, None, :] / safe
        terms2 = terms / safe
        psi = rho * torch.where(le_mask, terms, 0.0).sum(-1)
        phi = rho * torch.where(le_mask, 0.0, terms).sum(-1)
        dpsi = rho * torch.where(le_mask, terms2, 0.0).sum(-1)
        dphi = rho * torch.where(le_mask, 0.0, terms2).sum(-1)
        return psi, phi, dpsi, dphi

    p_mid, q_mid, _, _ = secular_parts(gap / 2, torch.zeros_like(alive))
    sig_right = 1.0 + p_mid + q_mid < 0
    zero = torch.zeros_like(gap)
    lo = torch.where(sig_right, -gap, zero)
    hi = torch.where(sig_right, zero, gap)
    mu = (lo + hi) / 2
    di = torch.where(sig_right, -gap, zero)  # left pole (mu coordinates)
    dn = torch.where(sig_right, zero, gap)  # right pole
    for _ in range(_secular_iters(dt)):
        psi, phi, dpsi, dphi = secular_parts(mu, sig_right)
        f = 1.0 + psi + phi
        fp = dpsi + dphi
        conv = f.abs() <= 8.0 * eps * (1.0 + psi.abs() + phi.abs())
        lo = torch.where(f < 0, mu, lo)
        hi = torch.where(f >= 0, mu, hi)
        # derivative-matched two-pole rational model (dlaed4 middle way)
        del_i = di - mu
        del_n = dn - mu
        p = dpsi * del_i * del_i
        q = dphi * del_n * del_n
        a = 1.0 + (psi - dpsi * del_i) + (phi - dphi * del_n)
        bq = -a * (di + dn) - p - q
        cq = a * di * dn + p * dn + q * di
        sq = torch.sqrt(torch.clamp_min(bq * bq - 4 * a * cq, 0.0))
        t1 = torch.where(bq >= 0, (-bq - sq) / 2, (-bq + sq) / 2)
        r1 = t1 / torch.where(a == 0, one, a)
        r2 = cq / torch.where(t1 == 0, one, t1)
        in1 = (r1 > lo) & (r1 < hi)
        in2 = (r2 > lo) & (r2 < hi)
        mid1 = in1 & (r1 > di) & (r1 < dn)
        mid2 = in2 & (r2 > di) & (r2 < dn)
        bis = (lo + hi) / 2
        cand = torch.where(
            mid1, r1, torch.where(mid2, r2, torch.where(in1, r1, torch.where(in2, r2, bis)))
        )
        # Newton fallback when the rational model degenerates
        newton = mu - f / torch.where(fp == 0, one, fp)
        cand = torch.where(
            torch.isfinite(cand), cand,
            torch.where((newton > lo) & (newton < hi), newton, bis),
        )
        # converged lanes freeze (re-applying the step is then a no-op)
        mu = torch.where(conv, mu, cand)
    mu = torch.minimum(torch.maximum(mu, lo), hi)
    sigma = torch.where(sig_right, nxt_d, dp)
    w = torch.where(alive, sigma + mu, ds)

    # --- Gu/Eisenstat recomputed z via the Loewner formula ---
    sig_minus_d = torch.where(sig_right[:, :, None], -(pd - gap[:, :, None]), -pd)
    lam_minus_d = sig_minus_d + mu[:, :, None]  # [b, k, i] = lam_k - dp_i
    pdT = -pd  # [b, k, i] = dp_k - dp_i
    eye = torch.eye(n2, dtype=torch.bool, device=dev)
    both = alive[:, :, None] & alive[:, None, :]
    ratio = torch.where(
        both & ~eye, lam_minus_d / torch.where(pdT == 0, one, pdT), one
    )
    own = torch.where(alive, torch.diagonal(lam_minus_d, dim1=1, dim2=2).abs(), one)
    zhat_abs = torch.sqrt(torch.prod(ratio, dim=1).abs() * own)
    zhat = torch.where(alive, torch.where(zs >= 0, zhat_abs, -zhat_abs), 0.0)

    # --- eigenvector assembly ---
    denom_u = -lam_minus_d.transpose(1, 2)  # [b, i, k] = dp_i - lam_k
    safe_u = torch.where(denom_u == 0, one, denom_u)
    u = torch.where(both, zhat[:, :, None] / safe_u, 0.0)
    norms = torch.sqrt((u * u).sum(dim=1))
    u = u / torch.where(norms == 0, one, norms)[:, None, :]
    u = torch.where((~alive[:, None, :]) & eye, one, u)

    qcat = torch.zeros((bsz, n2, n2), dtype=dt, device=dev)
    qcat[:, :m, :m] = q1
    qcat[:, m:, m:] = q2
    qp = torch.gather(qcat, 2, perm[:, None, :].expand(bsz, n2, n2))
    qnew = qp @ u

    order = torch.argsort(w, dim=1, stable=True)
    w = torch.gather(w, 1, order)
    qnew = torch.gather(qnew, 2, order[:, None, :].expand(bsz, n2, n2))
    return w, qnew


def _tridiag_dense(d, e):
    return torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)


@highest_precision
def stedc(d, e, leaf=64, leaf_solver=None):
    """All eigenpairs of the symmetric tridiagonal (d, e), on device.

    leaf_solver: None = auto ('xla' for fp32, 'jacobi' for fp64, as in
    the JAX package), 'xla' (torch.linalg.eigh) or 'jacobi'
    (ops/jacobi.py; a leaf of odd size takes dense eigh).
    """
    n = d.shape[0]
    dt = d.dtype
    dev = d.device
    if leaf_solver is None:
        leaf_solver = "xla" if dt == torch.float32 else "jacobi"
    if leaf_solver not in ("xla", "jacobi"):
        raise ValueError(f"unknown leaf_solver {leaf_solver!r}")

    def leaf_eigh(tb):
        if leaf_solver == "jacobi" and tb.shape[-1] % 2 == 0:
            return jacobi_eigh(tb)
        return torch.linalg.eigh(tb)

    if n <= 2 or n <= leaf:
        return leaf_eigh(_tridiag_dense(d, e))

    with trace_range("stedc"):
        # scale to unit norm-ish (dstedc scales by orgnrm)
        orgnrm = torch.maximum(d.abs().max(), e.abs().max())
        scale = torch.where(orgnrm > 0, orgnrm, torch.ones_like(orgnrm))
        d = d / scale
        e = e / scale

        # pad to a whole number of leaves with distinct decoupled values
        # just above the scaled spectrum (Gershgorin of T/scale <= 3)
        nblk = -(-n // leaf)
        npad = leaf * nblk
        pad = npad - n
        pad_vals = 4.0 + torch.arange(pad, dtype=dt, device=dev) * (1.0 / 1024.0)
        dp_full = torch.cat([d, pad_vals])
        e_full = torch.cat([e, torch.zeros((pad,), dtype=dt, device=dev)])
        if pad > 0:
            e_full[n - 1] = 0.0  # decouple the padding

        # way-down diagonal adjustments at every merge boundary
        bidx = torch.arange(1, nblk, device=dev) * leaf
        babs = e_full[bidx - 1].abs()
        dp_adj = dp_full.clone()
        dp_adj[bidx - 1] -= babs
        dp_adj[bidx] -= babs

        # leaves: batched dense eigh of leaf-sized tridiagonal blocks
        db = dp_adj.reshape(nblk, leaf)
        e_in = torch.cat([e_full[: npad - 1], torch.zeros((1,), dtype=dt, device=dev)])
        e_in = e_in.reshape(nblk, leaf).clone()
        e_in[:, -1] = 0.0  # drop the cross-block boundary e
        tb = torch.diag_embed(db) + torch.diag_embed(e_in[:, :-1], 1) + torch.diag_embed(
            e_in[:, :-1], -1
        )
        wb, qb = leaf_eigh(tb)

        gap_scale = torch.clamp_min(dp_full.abs().max(), 1.0)

        def tree(wb_c, qb_c, start_el, nblk_c):
            """Power-of-two merge tree over nblk_c leaves whose first
            element sits at global index start_el."""
            m = leaf
            sz = nblk_c * leaf
            while m < sz:
                pairs = sz // (2 * m)
                w2 = wb_c.reshape(pairs, 2, m)
                q2 = qb_c.reshape(pairs, 2, m, m)
                betas = e_full[start_el + (2 * torch.arange(pairs, device=dev) + 1) * m - 1]
                wb_c, qb_c = _merge_pair(
                    w2[:, 0], q2[:, 0], w2[:, 1], q2[:, 1], betas, gap_scale
                )
                m *= 2
            return wb_c.reshape(sz), qb_c.reshape(sz, sz)

        # binary decomposition of the block count, largest group first;
        # the groups fold left to right through unequal-size merges
        acc_w = acc_q = None
        start = 0
        for bit in reversed(range(nblk.bit_length())):
            size = 1 << bit
            if not nblk & size:
                continue
            wg, qg = tree(wb[start : start + size], qb[start : start + size],
                          start * leaf, size)
            if acc_w is None:
                acc_w, acc_q = wg, qg
            else:
                beta = e_full[start * leaf - 1].reshape(1)
                acc_w, acc_q = _merge_pair(
                    acc_w[None], acc_q[None], wg[None], qg[None], beta, gap_scale
                )
                acc_w, acc_q = acc_w[0], acc_q[0]
            start += size

        # padding deflates to eigenvalues >= 4 > Gershgorin(T/scale) <= 3,
        # so after the sorted merge the real pairs come first
        return acc_w[:n] * scale, acc_q[:n, :n]
