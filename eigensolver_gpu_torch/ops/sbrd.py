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

Every function here takes leading batch axes (a batch of problems of one
size, ``sygvdx_batched``): sbrd runs its panel loop once for the batch, one
panel call (one launch of K5 on the card) and one set of batched gemms a
panel step, and apply_q1 replays the batch's factors in the same batched
gemms. An unbatched call goes through the same code.

``sbrd(mesh=...)`` splits the rows over the mesh's 'tp' ranks (JAX: the
row-sharded operand of ``models/syevdx._tridiag_reduce``): rank r owns
the contiguous rows ``comm.row_range(n, mesh)``. Each panel is gathered
from the owners of its rows (one all_gather) and factored on every rank
(K5 on the card); the two-sided update forms Y and W on the rank's rows,
contracts V^T Y over the rows through an all_reduce, gathers W (one
all_gather) and updates the rank's own rows. The band comes out whole on
every rank: the panels are written everywhere, and the leading b x b
block, which the last update leaves on its owners, is gathered at the end.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.parallel import comm
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _ql_panel(p, rows_below):
    """QL factorization of the (m x b) panel ``p`` (rows at/after the
    pivot band are preserved untouched): b reflectors, column j
    (processed last to first) zeroing rows [0, rows_below + j) with its
    pivot at row rows_below + j. Returns (r_panel, v (m x b), tau (b,)).
    A column that is already zero above its pivot is trivial: tau = 0,
    v = 0 including the pivot entry, and the column is left as it was.
    Leading axes of ``p`` are a batch of panels, each factored on its own."""
    m, b = p.shape[-2:]
    lead = p.shape[:-2]
    p = p.clone()
    v_p = torch.zeros(lead + (m, b), dtype=p.dtype, device=p.device)
    tau = torch.zeros(lead + (b,), dtype=p.dtype, device=p.device)
    one = torch.ones((), dtype=p.dtype, device=p.device)
    zero = torch.zeros_like(one)
    for j in range(b - 1, -1, -1):
        top = rows_below + j
        x = p[..., :top, j]
        xnormsq = torch.sum(x * x, dim=-1)
        alpha = p[..., top, j]
        norm = torch.sqrt(alpha * alpha + xnormsq)
        beta = torch.where(alpha >= 0, -norm, norm)
        trivial = xnormsq == 0
        tau_k = torch.where(trivial, zero, (beta - alpha) / torch.where(trivial, one, beta))
        v = torch.zeros(lead + (m,), dtype=p.dtype, device=p.device)
        v[..., :top] = x / torch.where(trivial, one, alpha - beta)[..., None]
        v[..., top] = torch.where(trivial, zero, one)
        vp = (v[..., None, : top + 1] @ p[..., : top + 1, :j])[..., 0, :]
        p[..., : top + 1, :j] -= tau_k[..., None, None] * v[..., : top + 1, None] * vp[..., None, :]
        p[..., :top, j] = 0.0
        p[..., top, j] = torch.where(trivial, alpha, beta)
        v_p[..., :, j] = v
        tau[..., j] = tau_k
    return p, v_p, tau


def _larft_forward(v, tau):
    """T with H(0) H(1) ... H(b-1) = I - V T V^T (forward product order);
    leading axes a batch."""
    b = v.shape[-1]
    gram = v.mT @ v
    t = torch.zeros(v.shape[:-2] + (b, b), dtype=v.dtype, device=v.device)
    for j in range(b):
        t[..., :, j] = -tau[..., j, None] * (t[..., :, :j] @ gram[..., :j, j, None])[..., 0]
        t[..., j, j] = tau[..., j]
    return t


@highest_precision
def sbrd(a, band=32, bucket=512, panel_kernel=True, mesh=None):
    """Reduce symmetric ``a`` to a symmetric band matrix of half-width
    ``band``. Returns (ab, vs, ts): the banded matrix (full storage,
    entries outside the band zero) and the per-panel WY factors with
    a = Q1 ab Q1^T, Q1 = apply_q1(vs, ts, I). Requires n % band == 0 and
    n >= 3*band.

    Leading axes of ``a`` are a batch of problems: every panel step is one
    panel call (one launch of kernel K5 on the card) and one set of batched
    gemms for the whole batch, and the outputs gain the leading axes: vs
    (..., n // band - 1, n, band), ts (..., n // band - 1, band, band).

    panel_kernel: route each panel through ops/ql_panel.ql_panel (kernel
    K5 on a CUDA tensor). ``bucket`` is kept for the JAX signature.
    mesh: split the rows over its 'tp' ranks (module docstring); not
    used where the rows do not split evenly."""
    del bucket
    n = a.shape[-1]
    lead = a.shape[:-2]
    b = band
    if n % b != 0 or n < 3 * b:
        raise ValueError(f"sbrd requires n % band == 0 and n >= 3*band, got {n}, {b}")
    if panel_kernel:
        from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    a = ((a + a.mT) / 2).contiguous()
    npanels = n // b - 1  # pend = n, n-b, ..., 2b
    vs = torch.zeros(lead + (npanels, n, b), dtype=a.dtype, device=a.device)
    ts = torch.zeros(lead + (npanels, b, b), dtype=a.dtype, device=a.device)

    rows = comm.row_range(n, mesh)
    with trace_range("sbrd"):
        for p in range(npanels):
            pend = n - p * b
            mrows = pend - b
            if rows is not None:  # the panel, whole, from the ranks that own its rows
                a[..., :pend, mrows:pend] = comm.all_gather(
                    a[..., rows[0] : rows[1], mrows:pend], mesh, what="sbrd")[..., :pend, :]
            panel = a[..., :pend, mrows:pend]  # view, row stride n (batch stride n^2)
            if panel_kernel:
                pfac, v, _, t = ql_panel(panel, mrows - b)
            else:
                pfac, v, tau = _ql_panel(panel, mrows - b)
                t = _larft_forward(v, tau)
            v = v[..., :mrows, :]  # rows at and after mrows are zero
            # two-sided A <- N A N^T, N = I - V T V^T, via the symmetric
            # W-form: Y = A V T^T, S = T (V^T Y), W = Y - 1/2 V S,
            # A <- A - V W^T - W V^T, on the leading mrows x mrows block
            if rows is None:
                a_m = a[..., :mrows, :mrows]
                y = a_m @ (v @ t.mT)
                w = y - 0.5 * (v @ (t @ (v.mT @ y)))
                a_m -= torch.cat([v, w], dim=-1) @ torch.cat([w, v], dim=-1).mT
            else:
                _update_rows(a, v, t, mrows, rows, mesh)
            # the factored panel and its transpose
            a[..., :pend, mrows:pend] = pfac
            a[..., mrows:pend, :pend] = pfac.mT
            vs[..., p, :mrows, :] = v
            ts[..., p, :, :] = t
        if rows is not None:  # the leading block, last updated on its owners
            a[..., :b, :b] = comm.all_gather(
                a[..., rows[0] : rows[1], :b], mesh, what="sbrd")[..., :b, :]
    return a, vs, ts


def _update_rows(a, v, t, mrows, rows, mesh):
    """The two-sided update of sbrd on the rank's own rows of the leading
    mrows x mrows block: Y and W on rows lo:hi, V^T Y summed over the
    ranks, W gathered, then A[lo:hi] -= V[lo:hi] W^T + W[lo:hi] V^T."""
    lo, hi = rows
    top = max(lo, min(hi, mrows))  # the rank's rows above the block's edge end at top
    vr = v[..., lo:top, :]
    y = a[..., lo:top, :mrows] @ (v @ t.mT)
    vty = comm.all_reduce(vr.mT @ y, mesh, what="sbrd")
    w = torch.zeros(v.shape[:-2] + (hi - lo, v.shape[-1]), dtype=v.dtype, device=v.device)
    w[..., : top - lo, :] = y - 0.5 * (vr @ (t @ vty))
    w_all = comm.all_gather(w, mesh, what="sbrd")[..., :mrows, :]
    if top > lo:
        a[..., lo:top, :mrows] -= vr @ w_all.mT + w[..., : top - lo, :] @ v.mT


@highest_precision
def apply_q1(vs, ts, y, group=4):
    """y <- Q1 y where a = Q1 ab Q1^T from sbrd: panels applied in
    reverse processing order, y -= V S (V^T y) each (S = T^T).

    group: consecutive panels are pre-aggregated into one (n, group*b)
    compact-WY block by the dlarft composition
    (I - V1 S1 V1^T)(I - V2 S2 V2^T) = I - [V1 V2] Sc [V1 V2]^T,
    Sc = [[S1, -S1 (V1^T V2) S2], [0, S2]], so the replay runs a quarter
    of the gemms at four times the inner width. Aggregation is O(n^2 b),
    the replay O(n^2 m). Leading axes of vs, ts and y are a batch of
    problems, each replayed with its own factors in the same gemms."""
    npanels, n, b = vs.shape[-3:]
    lead = vs.shape[:-3]
    with trace_range("apply_q1"):
        g = max(1, min(group, npanels))
        ng = npanels // g
        rem = npanels - ng * g
        if g > 1 and ng > 0:
            v4 = vs[..., rem:, :, :].reshape(lead + (ng, g, n, b))
            s4 = ts[..., rem:, :, :].mT.reshape(lead + (ng, g, b, b))
            # fold panels left to right (apply order is right to left,
            # matching the per-panel loop's descending p)
            v_acc, s_acc = v4[..., 0, :, :], s4[..., 0, :, :]
            for j in range(1, g):
                vj, sj = v4[..., j, :, :], s4[..., j, :, :]
                cross = -(s_acc @ (v_acc.mT @ vj) @ sj)
                bot = torch.cat([torch.zeros(lead + (ng, b, s_acc.shape[-1]), dtype=s_acc.dtype,
                                             device=s_acc.device), sj], dim=-1)
                s_acc = torch.cat([torch.cat([s_acc, cross], dim=-1), bot], dim=-2)
                v_acc = torch.cat([v_acc, vj], dim=-1)
            for q in range(ng - 1, -1, -1):
                vq = v_acc[..., q, :, :]
                y = y - vq @ (s_acc[..., q, :, :] @ (vq.mT @ y))
        for p in range(rem - 1, -1, -1):
            vp = vs[..., p, :, :]
            y = y - vp @ (ts[..., p, :, :].mT @ (vp.mT @ y))
        return y
