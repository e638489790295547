"""Planar complex Householder tridiagonalization (twin of
eigensolver_gpu_tpu/ops/sytrd_planar.py; reference zhetrd_gpu.F90:30).

Reduces a Hermitian planar pair to real tridiagonal form with LAPACK
zhetrd/zlatrd conventions (UPLO='U', real beta and e, forced-real
diagonal), bucket by bucket from the bottom-right, one nb-column panel
at a time, each panel followed by a planar her2k on the leading block.

A panel runs either as the column loop below (``_panel_columns_planar``,
about 35 eager ops per column) or, with ``use_pallas=True`` on fp32
buckets whose size is a multiple of 256 and at most 4096, through the
hand-written latrd panel kernel (ops/latrd.py) -- the same gate as the
JAX package's ``pallas_ok``. The column loop's own ``use_pallas``
argument routes its ``A v`` through the upper-tile planar hemv kernel
(ops/symv.py); as in the JAX package, ``hetrd_planar`` never sets it
(its kernel route is the latrd panel). Both kernels take a leading batch
axis: a batch of problems runs each panel (or each column's ``A v``) in
one launch for all of them.

Unlike the JAX package, the working planes are updated IN PLACE: each
bucket is a view of the full planes, and the panel and her2k writes go
straight into it.

Returns (packed (ar, ai), d, e, (tau_r, tau_i)).
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
from eigensolver_gpu_torch.ops.symv import hemv_planar
from eigensolver_gpu_torch.ops.sytrd import _mv
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _larfg_planar(alphr, alphi, xnormsq):
    """zlarfg: returns (beta, tau_r, tau_i, scale_r, scale_i)."""
    norm = torch.sqrt(alphr * alphr + alphi * alphi + xnormsq)
    beta = torch.where(alphr >= 0, -norm, norm)
    trivial = (xnormsq == 0) & (alphi == 0)
    one = torch.ones_like(beta)
    safe_beta = torch.where(trivial, one, beta)
    tau_r = (beta - alphr) / safe_beta
    tau_i = -alphi / safe_beta
    dr = alphr - beta
    den = dr * dr + alphi * alphi
    safe_den = torch.where(trivial, one, den)
    scale_r = dr / safe_den
    scale_i = -alphi / safe_den
    zero = torch.zeros_like(beta)
    pick = lambda x: torch.where(trivial, zero, x)
    return (
        torch.where(trivial, alphr, beta),
        pick(tau_r),
        pick(tau_i),
        pick(scale_r),
        pick(scale_i),
    )


def _panel_columns_planar(ar, ai, d, e, taur, taui, panel_end, nb, use_pallas=False):
    """One zlatrd panel, columns panel_end-1 down to panel_end-nb, as an
    eager column loop. Writes the packed columns into (ar, ai) and the
    scalars into d, e, taur, taui in place; returns the compact-WY
    panels (vr, vi, wr, wi), (mb, nb), slot k = column panel_end-1-k.
    Leading axes are a batch of problems, each column one set of ops for
    the whole batch (per-item scalars are tensors of the batch shape).

    v is zero from row cj on and w is masked to rows < cj, so the matvec
    and corrections run on the leading cj rows only. With ``use_pallas``
    the matvec is the planar hemv kernel on the leading cj x cj block
    (one launch for the batch)."""
    mb = ar.shape[-1]
    vr = torch.zeros(ar.shape[:-2] + (mb, nb), dtype=ar.dtype, device=ar.device)
    vi, wr, wi = torch.zeros_like(vr), torch.zeros_like(vr), torch.zeros_like(vr)
    rows = torch.arange(mb, device=ar.device)
    for k in range(nb):
        cj = panel_end - 1 - k
        acr = ar[..., :, cj]
        aci = ai[..., :, cj]
        if k > 0:
            # a_col -= [V W] @ conj([w_row; v_row])   (zlatrd's zlacgv'd pair)
            V_r, V_i, W_r, W_i = vr[..., :, :k], vi[..., :, :k], wr[..., :, :k], wi[..., :, :k]
            wrow_r, wrow_i = W_r[..., cj, :], W_i[..., cj, :]
            vrow_r, vrow_i = V_r[..., cj, :], V_i[..., cj, :]
            acr = acr - (_mv(V_r, wrow_r) + _mv(V_i, wrow_i) + _mv(W_r, vrow_r)
                         + _mv(W_i, vrow_i))
            aci = aci - (_mv(V_i, wrow_r) - _mv(V_r, wrow_i) + _mv(W_i, vrow_r)
                         - _mv(W_r, vrow_i))
        d_val = acr[..., cj]  # diagonal forced real (zlatrd A(I,I)=DBLE(...))

        pidx = max(cj - 1, 0)
        has_r = cj > 0
        xmask = rows < cj - 1
        x_r = torch.where(xmask, acr, 0.0)
        x_i = torch.where(xmask, aci, 0.0)
        xnormsq = torch.sum(x_r * x_r + x_i * x_i, dim=-1)
        beta, tk_r, tk_i, sc_r, sc_i = _larfg_planar(acr[..., pidx], aci[..., pidx], xnormsq)
        if not has_r:
            tk_r = torch.zeros_like(tk_r)
            tk_i = torch.zeros_like(tk_i)
        # the per-item scalars against vectors (views, no copies)
        tk_rv, tk_iv = tk_r[..., None], tk_i[..., None]
        v_r = x_r * sc_r[..., None] - x_i * sc_i[..., None]
        v_i = x_r * sc_i[..., None] + x_i * sc_r[..., None]
        if has_r:
            v_r[..., cj - 1] = 1.0
            v_i[..., cj - 1] = 0.0

        # y = A v - [V W] ([W V]^H v) on rows < cj (the reference's zhemv)
        c = cj
        vt_r, vt_i = v_r[..., :c], v_i[..., :c]
        if use_pallas and c > 0:
            y_r, y_i = hemv_planar(ar, ai, vt_r, vt_i, extent=c)
        else:
            a_r, a_i = ar[..., :c, :c], ai[..., :c, :c]
            y_r = _mv(a_r, vt_r) - _mv(a_i, vt_i)
            y_i = _mv(a_r, vt_i) + _mv(a_i, vt_r)
        if k > 0:
            V_r, V_i = vr[..., :c, :k], vi[..., :c, :k]
            W_r, W_i = wr[..., :c, :k], wi[..., :c, :k]
            zw_r = _mv(W_r.mT, vt_r) + _mv(W_i.mT, vt_i)  # W^H v
            zw_i = _mv(W_r.mT, vt_i) - _mv(W_i.mT, vt_r)
            zv_r = _mv(V_r.mT, vt_r) + _mv(V_i.mT, vt_i)  # V^H v
            zv_i = _mv(V_r.mT, vt_i) - _mv(V_i.mT, vt_r)
            y_r = y_r - (_mv(V_r, zw_r) - _mv(V_i, zw_i) + _mv(W_r, zv_r) - _mv(W_i, zv_i))
            y_i = y_i - (_mv(V_r, zw_i) + _mv(V_i, zw_r) + _mv(W_r, zv_i) + _mv(W_i, zv_r))
        # w = tau y;  alpha = -1/2 tau (w^H v);  w += alpha v
        w_r = tk_rv * y_r - tk_iv * y_i
        w_i = tk_rv * y_i + tk_iv * y_r
        hr = torch.sum(w_r * vt_r + w_i * vt_i, dim=-1)
        hi = torch.sum(w_r * vt_i - w_i * vt_r, dim=-1)
        al_r = (-0.5 * (tk_r * hr - tk_i * hi))[..., None]
        al_i = (-0.5 * (tk_r * hi + tk_i * hr))[..., None]
        vr[..., :, k] = v_r
        vi[..., :, k] = v_i
        wr[..., :c, k] = w_r + al_r * vt_r - al_i * vt_i
        wi[..., :c, k] = w_i + al_r * vt_i + al_i * vt_r

        # packed column (LAPACK storage) and the per-column scalars
        new_r = torch.where(xmask, v_r, acr)
        new_i = torch.where(xmask, v_i, aci)
        if has_r:
            new_r[..., cj - 1] = beta
            new_i[..., cj - 1] = 0.0
            e[..., pidx] = beta
            taur[..., pidx] = tk_r
            taui[..., pidx] = tk_i
        new_r[..., cj] = d_val
        new_i[..., cj] = 0.0
        d[..., cj] = d_val
        ar[..., :, cj] = new_r
        ai[..., :, cj] = new_i
    return vr, vi, wr, wi


def _panel_via_kernel(ar_mb, ai_mb, d, e, taur, taui, panel_end, nb):
    """Run the panel through the latrd kernel (ops/latrd.py) and fold its
    slot-ordered outputs back into LAPACK layout, in place (each item of a
    batch, from one launch)."""
    vr, vi, wr, wi, colr, coli, scal = latrd_panel_planar(
        ar_mb, ai_mb, panel_end, nb=nb
    )
    pe = panel_end
    start = pe - nb
    ar_mb[..., :, start:pe] = torch.flip(colr, (-1,))
    ai_mb[..., :, start:pe] = torch.flip(coli, (-1,))
    d[..., start:pe] = torch.flip(scal[..., 0, :], (-1,))
    # slot k targets e/tau index pe-2-k; the slot of column 0 (only when
    # start == 0) has no target
    for vec, row in ((e, 1), (taur, 2), (taui, 3)):
        vals = torch.flip(scal[..., row, :], (-1,))
        if start > 0:
            vec[..., start - 1 : pe - 1] = vals
        else:
            vec[..., : pe - 1] = vals[..., 1:]
    return vr, vi, wr, wi


@highest_precision
def hetrd_planar(a_r, a_i, nb=32, bucket=512, use_pallas=False):
    """Planar blocked hetrd. Returns ((ar, ai) packed, d, e, (taur, taui)).

    Leading axes of (a_r, a_i) are a batch of problems, reduced together
    column by column, or with ``use_pallas`` panel by panel (one latrd
    launch a panel for the batch; the kernel takes one batch axis)."""
    n = a_r.shape[-1]
    if n % nb != 0:
        raise ValueError(f"hetrd_planar requires n % nb == 0, got n={n}, nb={nb}")
    lead = a_r.shape[:-2]
    rdt = a_r.dtype
    dev = a_r.device
    # hermitize in planar form: Ar <- (Ar+Ar^T)/2, Ai <- (Ai-Ai^T)/2
    ar = (a_r + a_r.mT) / 2
    ai = (a_i - a_i.mT) / 2
    d = torch.zeros(lead + (n,), dtype=rdt, device=dev)
    e = torch.zeros(lead + (max(n - 1, 1),), dtype=rdt, device=dev)
    taur = torch.zeros_like(e)
    taui = torch.zeros_like(e)

    with trace_range("hetrd_planar"):
        num_buckets = -(-n // bucket)
        for b in range(num_buckets, 0, -1):
            mb = min(b * bucket, n)
            lo = (b - 1) * bucket
            ar_mb = ar[..., :mb, :mb]  # views: updated in place
            ai_mb = ai[..., :mb, :mb]
            kernel_ok = (
                use_pallas and rdt == torch.float32 and mb % 256 == 0 and mb <= 4096
            )
            panel = _panel_via_kernel if kernel_ok else _panel_columns_planar
            for p in range((mb - lo) // nb):
                pe = mb - p * nb
                vr, vi, wr, wi = panel(ar_mb, ai_mb, d, e, taur, taui, pe, nb)
                # trailing her2k on the leading t x t block: A -= V W^H + W V^H
                t = pe - nb
                vr, vi = vr[..., :t, :], vi[..., :t, :]
                wr, wi = wr[..., :t, :], wi[..., :t, :]
                p_r = vr @ wr.mT + vi @ wi.mT  # (V W^H)_r
                p_i = vi @ wr.mT - vr @ wi.mT  # (V W^H)_i
                ar_mb[..., :t, :t] -= p_r + p_r.mT
                ai_mb[..., :t, :t] -= p_i - p_i.mT

    ne = n - 1 if n > 1 else 0
    return (ar, ai), d, e[..., :ne], (taur[..., :ne], taui[..., :ne])
