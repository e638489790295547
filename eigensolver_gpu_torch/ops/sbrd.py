"""Successive band reduction, stage 1: dense symmetric -> banded (twin of
eigensolver_gpu_tpu/ops/sbrd.py).

First stage of the two-stage tridiagonalization (stage 2 = bulge chasing
in ops/sb2st.py): reducing first to a band of half-width ``b`` moves the
O(n^3) work into per-panel two-sided compact-WY gemm updates and leaves
one QL panel factorization per b columns.

Convention (matches ops/sytrd.py): UPLO='U' processed from the last
column backward, so the active submatrix is always the leading principal
block. Panel columns are eliminated with QL-style Householder
reflectors; the two-sided update uses the symmetric W-form.

Returns the banded matrix plus the per-panel (V, T) factors;
``apply_q1`` replays them onto eigenvector columns (Z = Q1 y).

Port differences: the working matrix is updated in place on views, and
each panel works on its own leading ``pend x pend`` block (rows at and
after ``pend`` hold zeros in V and W), where the JAX loop masks a
bucket-sized block. ``bucket`` is therefore accepted and has no effect.
With ``panel_kernel=True`` the panel goes through the ``ql_panel``
wrapper (kernel K5 on CUDA tensors, ``_ql_panel`` + ``_larft_forward`` on
CPU tensors); with False it takes the two plain functions directly.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _ql_panel(p, rows_below):
    """QL factorization of the (m x b) panel ``p`` (rows at/after the
    pivot band are preserved untouched): b reflectors, column j
    (processed last to first) zeroing rows [0, rows_below + j) with its
    pivot at row rows_below + j. Returns (r_panel, v (m x b), tau (b,)).
    A column that is already zero above its pivot is trivial: tau = 0,
    v = 0 including the pivot entry, and the column is left as it was."""
    m, b = p.shape
    p = p.clone()
    v_p = torch.zeros((m, b), dtype=p.dtype, device=p.device)
    tau = torch.zeros((b,), dtype=p.dtype, device=p.device)
    one = torch.ones((), dtype=p.dtype, device=p.device)
    zero = torch.zeros_like(one)
    for j in range(b - 1, -1, -1):
        top = rows_below + j
        x = p[:top, j]
        xnormsq = torch.sum(x * x)
        alpha = p[top, j]
        norm = torch.sqrt(alpha * alpha + xnormsq)
        beta = torch.where(alpha >= 0, -norm, norm)
        trivial = xnormsq == 0
        tau_k = torch.where(trivial, zero, (beta - alpha) / torch.where(trivial, one, beta))
        v = torch.zeros((m,), dtype=p.dtype, device=p.device)
        v[:top] = x / torch.where(trivial, one, alpha - beta)
        v[top] = torch.where(trivial, zero, one)
        vp = v[: top + 1] @ p[: top + 1, :j]
        p[: top + 1, :j] -= tau_k * v[: top + 1, None] * vp[None, :]
        p[:top, j] = 0.0
        p[top, j] = torch.where(trivial, alpha, beta)
        v_p[:, j] = v
        tau[j] = tau_k
    return p, v_p, tau


def _larft_forward(v, tau):
    """T with H(0) H(1) ... H(b-1) = I - V T V^T (forward product order)."""
    b = v.shape[1]
    gram = v.T @ v
    t = torch.zeros((b, b), dtype=v.dtype, device=v.device)
    for j in range(b):
        t[:, j] = -tau[j] * (t[:, :j] @ gram[:j, j])
        t[j, j] = tau[j]
    return t


@highest_precision
def sbrd(a, band=32, bucket=512, panel_kernel=True):
    """Reduce symmetric ``a`` to a symmetric band matrix of half-width
    ``band``. Returns (ab, vs, ts): the banded matrix (full storage,
    entries outside the band zero) and the per-panel WY factors with
    a = Q1 ab Q1^T, Q1 = apply_q1(vs, ts, I). Requires n % band == 0 and
    n >= 3*band.

    panel_kernel: route each panel through ops/ql_panel.ql_panel (kernel
    K5 on a CUDA tensor). ``bucket`` is kept for the JAX signature."""
    del bucket
    n = a.shape[0]
    b = band
    if n % b != 0 or n < 3 * b:
        raise ValueError(f"sbrd requires n % band == 0 and n >= 3*band, got {n}, {b}")
    if panel_kernel:
        from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    a = ((a + a.T) / 2).contiguous()
    npanels = n // b - 1  # pend = n, n-b, ..., 2b
    vs = torch.zeros((npanels, n, b), dtype=a.dtype, device=a.device)
    ts = torch.zeros((npanels, b, b), dtype=a.dtype, device=a.device)

    with trace_range("sbrd"):
        for p in range(npanels):
            pend = n - p * b
            mrows = pend - b
            panel = a[:pend, mrows:pend]  # view, row stride n
            if panel_kernel:
                pfac, v, _, t = ql_panel(panel, mrows - b)
            else:
                pfac, v, tau = _ql_panel(panel, mrows - b)
                t = _larft_forward(v, tau)
            v = v[:mrows]  # rows at and after mrows are zero
            # two-sided A <- N A N^T, N = I - V T V^T, via the symmetric
            # W-form: Y = A V T^T, S = T (V^T Y), W = Y - 1/2 V S,
            # A <- A - V W^T - W V^T, on the leading mrows x mrows block
            a_m = a[:mrows, :mrows]
            y = a_m @ (v @ t.T)
            w = y - 0.5 * (v @ (t @ (v.T @ y)))
            a_m -= torch.cat([v, w], dim=1) @ torch.cat([w, v], dim=1).T
            # the factored panel and its transpose
            a[:pend, mrows:pend] = pfac
            a[mrows:pend, :pend] = pfac.T
            vs[p, :mrows] = v
            ts[p] = t
    return a, vs, ts


@highest_precision
def apply_q1(vs, ts, y, group=4):
    """y <- Q1 y where a = Q1 ab Q1^T from sbrd: panels applied in
    reverse processing order, y -= V S (V^T y) each (S = T^T).

    group: consecutive panels are pre-aggregated into one (n, group*b)
    compact-WY block by the dlarft composition
    (I - V1 S1 V1^T)(I - V2 S2 V2^T) = I - [V1 V2] Sc [V1 V2]^T,
    Sc = [[S1, -S1 (V1^T V2) S2], [0, S2]], so the replay runs a quarter
    of the gemms at four times the inner width. Aggregation is O(n^2 b),
    the replay O(n^2 m)."""
    npanels, n, b = vs.shape
    with trace_range("apply_q1"):
        g = max(1, min(group, npanels))
        ng = npanels // g
        rem = npanels - ng * g
        if g > 1 and ng > 0:
            v4 = vs[rem:].reshape(ng, g, n, b)
            s4 = ts[rem:].transpose(1, 2).reshape(ng, g, b, b)
            # fold panels left to right (apply order is right to left,
            # matching the per-panel loop's descending p)
            v_acc, s_acc = v4[:, 0], s4[:, 0]
            for j in range(1, g):
                vj, sj = v4[:, j], s4[:, j]
                cross = -(s_acc @ (v_acc.transpose(1, 2) @ vj) @ sj)
                bot = torch.cat([torch.zeros((ng, b, s_acc.shape[1]), dtype=s_acc.dtype,
                                             device=s_acc.device), sj], dim=2)
                s_acc = torch.cat([torch.cat([s_acc, cross], dim=2), bot], dim=1)
                v_acc = torch.cat([v_acc, vj], dim=2)
            for q in range(ng - 1, -1, -1):
                y = y - v_acc[q] @ (s_acc[q] @ (v_acc[q].T @ y))
        for p in range(rem - 1, -1, -1):
            y = y - vs[p] @ (ts[p].T @ (vs[p].T @ y))
        return y
