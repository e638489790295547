"""Planar complex successive band reduction, stage 1: dense Hermitian ->
Hermitian band (twin of eigensolver_gpu_tpu/ops/sbrd_planar.py; the
complex twin of ops/sbrd.py on (re, im) planes).

Reducing first to a band of half-width ``b`` moves the O(n^3) work into
per-panel two-sided compact-WY planar gemms (Karatsuba, three real
products each) and leaves one QL panel factorization per b columns;
stage 2 is the planar bulge chase (ops/sb2st_planar.py).

The Hermitian W-form (A Hermitian, N = I - V T V^H from the forward
larft):

    N A N^H = A - V W^H - W V^H,   Y = A (V T^H),  S = T (V^H Y),
    W = Y - 1/2 V S

(S = T V^H A V T^H is Hermitian, which folds the three correction terms
into the two-sided pair as in the real case.) The panel applies ``H^H``
per column (zlarfg's annihilation side), so the accumulated block is
``N = H_0^H .. H_{b-1}^H = I - V T' V^H`` with T' the forward larft of the
CONJUGATED taus.

Returns the banded planar pair plus per-panel planar (V, T) factors;
``apply_q1_planar`` replays them onto planar eigenvector columns.

Port differences, as in ops/sbrd.py: the working planes are updated in
place on views and each panel works on its own leading ``pend x pend``
block, so ``bucket`` is accepted and has no effect. With
``panel_kernel=True`` the panel goes through the ``ql_panel_planar``
wrapper (kernel K6 on CUDA tensors, the plain pair below on CPU tensors);
with False it takes ``_ql_panel_planar`` + ``_larft_forward_planar``
directly.

Every function here takes leading batch axes (a batch of problems of one
size, ``zhegvdx_planar_batched``): psbrd runs its panel loop once for the
batch, one panel call (one launch of K6 on the card) and one set of batched
planar gemms a panel step, and apply_q1_planar replays the batch's factors
in the same batched gemms.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.pchol import _outer
from eigensolver_gpu_torch.ops.sytrd_planar import _larfg_planar
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _pmm(xr, xi, yr, yi):
    """Planar complex matmul (Karatsuba: 3 real gemms), batched or not."""
    m1 = xr @ yr
    m2 = xi @ yi
    m3 = (xr + xi) @ (yr + yi)
    return m1 - m2, m3 - m1 - m2


def _pmm_h(xr, xi, yr, yi):
    """X^H Y planar (Karatsuba)."""
    return _pmm(xr.transpose(-1, -2), -xi.transpose(-1, -2), yr, yi)


def _ql_panel_planar(pr, pi, rows_below):
    """QL factorization of the planar (m x b) panel: b complex reflectors,
    column j (processed last to first) zeroing rows [0, rows_below + j)
    with its pivot at row rows_below + j (the pivot becomes REAL beta,
    zlarfg convention). Columns to the left take ``H^H``. A column with a
    zero tail and a real pivot is trivial: tau = 0, v = 0 including the
    pivot entry, the column left as it was. Returns
    (pr, pi, vr, vi, tau_r, tau_i); leading axes of the planes are a batch
    of panels, each factored on its own."""
    m, b = pr.shape[-2:]
    lead = pr.shape[:-2]
    pr, pi = pr.clone(), pi.clone()
    vr_p = torch.zeros(lead + (m, b), dtype=pr.dtype, device=pr.device)
    vi_p = torch.zeros_like(vr_p)
    tr = torch.zeros(lead + (b,), dtype=pr.dtype, device=pr.device)
    ti = torch.zeros_like(tr)
    for j in range(b - 1, -1, -1):
        top = rows_below + j
        xr, xi = pr[..., :top, j], pi[..., :top, j]
        xnormsq = torch.sum(xr * xr + xi * xi, dim=-1)
        beta, tk_r, tk_i, sc_r, sc_i = _larfg_planar(pr[..., top, j], pi[..., top, j], xnormsq)
        trivial = (tk_r == 0) & (tk_i == 0)
        # v = scale * x above the pivot, 1 at the pivot (0 when trivial)
        v_r = torch.zeros(lead + (top + 1,), dtype=pr.dtype, device=pr.device)
        v_i = torch.zeros_like(v_r)
        v_r[..., :top] = xr * sc_r[..., None] - xi * sc_i[..., None]
        v_i[..., :top] = xr * sc_i[..., None] + xi * sc_r[..., None]
        v_r[..., top] = torch.where(trivial, torch.zeros_like(beta), torch.ones_like(beta))
        # P[:, :j] <- P[:, :j] - v (conj(tau) (v^H P[:, :j]))
        left_r, left_i = pr[..., : top + 1, :j], pi[..., : top + 1, :j]
        vp_r = _vecmat(v_r, left_r) + _vecmat(v_i, left_i)
        vp_i = _vecmat(v_r, left_i) - _vecmat(v_i, left_r)
        tk_r1, tk_i1 = tk_r[..., None], tk_i[..., None]
        tvp_r = tk_r1 * vp_r + tk_i1 * vp_i
        tvp_i = tk_r1 * vp_i - tk_i1 * vp_r
        left_r -= _outer(v_r, tvp_r) - _outer(v_i, tvp_i)
        left_i -= _outer(v_r, tvp_i) + _outer(v_i, tvp_r)
        pr[..., :top, j] = 0.0
        pi[..., :top, j] = 0.0
        pr[..., top, j] = beta  # the pivot itself when trivial
        pi[..., top, j] = 0.0  # a trivial column's pivot is real already
        vr_p[..., : top + 1, j] = v_r
        vi_p[..., : top + 1, j] = v_i
        tr[..., j] = tk_r
        ti[..., j] = tk_i
    return pr, pi, vr_p, vi_p, tr, ti


def _vecmat(v, x):
    """v^T X for a vector and a matrix, or for batches of them."""
    return (v[..., None, :] @ x)[..., 0, :]


def _matvec(x, v):
    """X v for a matrix and a vector, or for batches of them."""
    return (x @ v[..., :, None])[..., 0]


def _larft_forward_planar(vr, vi, tr, ti):
    """Planar T with H(0) H(1) ... H(b-1) = I - V T V^H; leading axes a
    batch."""
    b = vr.shape[-1]
    mr, mi = _pmm_h(vr, vi, vr, vi)  # V^H V
    t_r = torch.zeros(vr.shape[:-2] + (b, b), dtype=vr.dtype, device=vr.device)
    t_i = torch.zeros_like(t_r)
    for j in range(b):
        # col = -tau_j * (T[:, :j] @ M[:j, j])
        a_r = _matvec(t_r[..., :, :j], mr[..., :j, j]) - _matvec(t_i[..., :, :j], mi[..., :j, j])
        a_i = _matvec(t_r[..., :, :j], mi[..., :j, j]) + _matvec(t_i[..., :, :j], mr[..., :j, j])
        tj_r, tj_i = tr[..., j, None], ti[..., j, None]
        t_r[..., :, j] = -(tj_r * a_r - tj_i * a_i)
        t_i[..., :, j] = -(tj_r * a_i + tj_i * a_r)
        t_r[..., j, j] = tr[..., j]
        t_i[..., j, j] = ti[..., j]
    return t_r, t_i


@highest_precision
def psbrd(a_r, a_i, band=32, bucket=512, panel_kernel=True):
    """Reduce the Hermitian planar pair to a Hermitian band of half-width
    ``band``. Returns ((abr, abi), (vs_r, vs_i), (ts_r, ts_i)): the banded
    planar pair (full storage, entries outside the band zero) and the
    per-panel planar WY factors with a = Q1 ab Q1^H,
    Q1 = apply_q1_planar(vs, ts, I). Requires n % band == 0, n >= 3*band.

    Leading axes of the planes are a batch of problems: every panel step is
    one panel call (one launch of kernel K6 on the card) and one set of
    batched planar gemms for the whole batch, and the outputs gain the
    leading axes: vs (..., n // band - 1, n, band), ts (..., n // band - 1,
    band, band).

    panel_kernel: route each panel through ops/ql_panel.ql_panel_planar
    (kernel K6 on a CUDA tensor). ``bucket`` is kept for the JAX signature."""
    del bucket
    n = a_r.shape[-1]
    lead = a_r.shape[:-2]
    b = band
    if n % b != 0 or n < 3 * b:
        raise ValueError(f"psbrd requires n % band == 0 and n >= 3*band, got {n}, {b}")
    if panel_kernel:
        from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar
    ar = ((a_r + a_r.mT) / 2).contiguous()
    ai = ((a_i - a_i.mT) / 2).contiguous()
    npanels = n // b - 1  # pend = n, n-b, ..., 2b
    vs_r = torch.zeros(lead + (npanels, n, b), dtype=ar.dtype, device=ar.device)
    vs_i = torch.zeros_like(vs_r)
    ts_r = torch.zeros(lead + (npanels, b, b), dtype=ar.dtype, device=ar.device)
    ts_i = torch.zeros_like(ts_r)

    with trace_range("psbrd"):
        for p in range(npanels):
            pend = n - p * b
            mrows = pend - b
            # views, row stride n (and batch stride n^2)
            pan_r, pan_i = ar[..., :pend, mrows:pend], ai[..., :pend, mrows:pend]
            if panel_kernel:
                pf_r, pf_i, v_r, v_i, _, _, t_r, t_i = ql_panel_planar(pan_r, pan_i, mrows - b)
            else:
                pf_r, pf_i, v_r, v_i, tk_r, tk_i = _ql_panel_planar(pan_r, pan_i, mrows - b)
                t_r, t_i = _larft_forward_planar(v_r, v_i, tk_r, -tk_i)
            # rows at and after mrows are zero
            v_r, v_i = v_r[..., :mrows, :], v_i[..., :mrows, :]
            # two-sided A <- N A N^H via the Hermitian W-form, on the
            # leading mrows x mrows block
            am_r, am_i = ar[..., :mrows, :mrows], ai[..., :mrows, :mrows]
            y_r, y_i = _pmm(am_r, am_i, *_pmm(v_r, v_i, t_r.mT, -t_i.mT))  # A (V T^H)
            s_r, s_i = _pmm(t_r, t_i, *_pmm_h(v_r, v_i, y_r, y_i))
            vs2_r, vs2_i = _pmm(v_r, v_i, s_r, s_i)
            w_r = y_r - 0.5 * vs2_r
            w_i = y_i - 0.5 * vs2_i
            # A -= V W^H + W V^H  (P = V W^H; the update is P + P^H)
            p_r, p_i = _pmm(v_r, v_i, w_r.mT, -w_i.mT)
            am_r -= p_r + p_r.mT
            am_i -= p_i - p_i.mT
            # the factored panel and its conjugate transpose
            ar[..., :pend, mrows:pend] = pf_r
            ai[..., :pend, mrows:pend] = pf_i
            ar[..., mrows:pend, :pend] = pf_r.mT
            ai[..., mrows:pend, :pend] = -pf_i.mT
            vs_r[..., p, :mrows, :] = v_r
            vs_i[..., p, :mrows, :] = v_i
            ts_r[..., p, :, :], ts_i[..., p, :, :] = t_r, t_i
    return (ar, ai), (vs_r, vs_i), (ts_r, ts_i)


@highest_precision
def apply_q1_planar(vs, ts, y, group=4):
    """y <- Q1 y (planar) where a = Q1 ab Q1^H from psbrd: panels applied
    in reverse processing order, y -= V S (V^H y) each (S = T^H). Leading
    axes of vs, ts and y are a batch of problems, each replayed with its
    own factors in the same gemms.

    group: consecutive panels pre-aggregated into one (n, group*b) planar
    compact-WY block via (I - V1 S1 V1^H)(I - V2 S2 V2^H) =
    I - [V1 V2] Sc [V1 V2]^H, Sc = [[S1, -S1 (V1^H V2) S2], [0, S2]]: the
    complex twin of ops/sbrd.apply_q1's aggregation."""
    vs_r, vs_i = vs
    ts_r, ts_i = ts
    y_r, y_i = y
    npanels, n, b = vs_r.shape[-3:]
    lead = vs_r.shape[:-3]

    def reflect(v_r, v_i, s_r, s_i, y_r, y_i):
        """y - V (S (V^H y))."""
        d_r, d_i = _pmm(v_r, v_i, *_pmm(s_r, s_i, *_pmm_h(v_r, v_i, y_r, y_i)))
        return y_r - d_r, y_i - d_i

    with trace_range("apply_q1_planar"):
        g = max(1, min(group, npanels))
        ng = npanels // g
        rem = npanels - ng * g
        if g > 1 and ng > 0:
            v4_r = vs_r[..., rem:, :, :].reshape(lead + (ng, g, n, b))
            v4_i = vs_i[..., rem:, :, :].reshape(lead + (ng, g, n, b))
            s4_r = ts_r[..., rem:, :, :].mT.reshape(lead + (ng, g, b, b))  # S = T^H
            s4_i = -ts_i[..., rem:, :, :].mT.reshape(lead + (ng, g, b, b))
            va_r, va_i = v4_r[..., 0, :, :], v4_i[..., 0, :, :]
            sa_r, sa_i = s4_r[..., 0, :, :], s4_i[..., 0, :, :]
            for j in range(1, g):
                vj_r, vj_i = v4_r[..., j, :, :], v4_i[..., j, :, :]
                sj_r, sj_i = s4_r[..., j, :, :], s4_i[..., j, :, :]
                # cross = -S_acc (V_acc^H V_j) S_j
                cr_r, cr_i = _pmm(*_pmm(sa_r, sa_i, *_pmm_h(va_r, va_i, vj_r, vj_i)), sj_r, sj_i)
                zt = torch.zeros(lead + (ng, b, sa_r.shape[-1]), dtype=sa_r.dtype,
                                 device=sa_r.device)
                sa_r = torch.cat([torch.cat([sa_r, -cr_r], dim=-1),
                                  torch.cat([zt, sj_r], dim=-1)], dim=-2)
                sa_i = torch.cat([torch.cat([sa_i, -cr_i], dim=-1),
                                  torch.cat([zt, sj_i], dim=-1)], dim=-2)
                va_r = torch.cat([va_r, vj_r], dim=-1)
                va_i = torch.cat([va_i, vj_i], dim=-1)
            for q in range(ng - 1, -1, -1):
                y_r, y_i = reflect(va_r[..., q, :, :], va_i[..., q, :, :],
                                   sa_r[..., q, :, :], sa_i[..., q, :, :], y_r, y_i)
        for p in range(rem - 1, -1, -1):
            y_r, y_i = reflect(vs_r[..., p, :, :], vs_i[..., p, :, :],
                               ts_r[..., p, :, :].mT, -ts_i[..., p, :, :].mT, y_r, y_i)
        return y_r, y_i
