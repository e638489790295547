"""Planar blocked WY back-transformation (twin of
eigensolver_gpu_tpu/ops/unmtr_planar.py; zunmtr without complex dtypes).

Applies Q = H(n-2)...H(0) from hetrd_planar to a planar matrix:
(cr, ci) <- Q @ (cr, ci), nb reflectors at a time: every block's V is
extracted and every T factor built at once (a kb-step recurrence
batched over the blocks), then each block is applied with two planar
gemms, C -= V (T (V^H C)).
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _block_v_planar(ar, ai, r0, kb, nref):
    """Reflectors r0..r0+kb-1 as unit-diagonal columns (zero-padded past
    nref); reflector j lives above row j of column j+1 (UPLO='U')."""
    n = ar.shape[-2]
    cr = ar[..., :, r0 + 1 : r0 + 1 + kb]
    ci = ai[..., :, r0 + 1 : r0 + 1 + kb]
    rows = torch.arange(n, device=ar.device)[:, None]
    refl = torch.arange(kb, device=ar.device)[None, :] + r0
    valid = refl < nref
    keep = (rows < refl) & valid
    one = (rows == refl) & valid
    vr = torch.where(one, 1.0, torch.where(keep, cr, 0.0))
    vi = torch.where(keep, ci, 0.0)
    return vr, vi


def _larft_left_batched(vr, vi, tr, ti):
    """T factors for all reflector blocks at once (leading axes: blocks,
    and problems before them): the rows of each T are a sequential
    recurrence, the blocks are independent, so one loop over kb rows
    builds every block's T."""
    kb = vr.shape[-1]
    m_r = vr.mT @ vr + vi.mT @ vi  # V^H V
    m_i = vr.mT @ vi - vi.mT @ vr
    t_r = torch.zeros(vr.shape[:-2] + (kb, kb), dtype=vr.dtype, device=vr.device)
    t_i = torch.zeros_like(t_r)
    for j in range(kb):
        mrow_r = m_r[..., j, :j].unsqueeze(-2)
        mrow_i = m_i[..., j, :j].unsqueeze(-2)
        # row j = -tau_j * (m[j, :j] @ T[:j, :]), diagonal tau_j
        pr = (mrow_r @ t_r[..., :j, :] - mrow_i @ t_i[..., :j, :]).squeeze(-2)
        pi = (mrow_r @ t_i[..., :j, :] + mrow_i @ t_r[..., :j, :]).squeeze(-2)
        tj_r = tr[..., j, None]
        tj_i = ti[..., j, None]
        t_r[..., j, :] = -(tj_r * pr - tj_i * pi)
        t_i[..., j, :] = -(tj_r * pi + tj_i * pr)
        t_r[..., j, j] = tr[..., j]
        t_i[..., j, j] = ti[..., j]
    return t_r, t_i


@highest_precision
def unmtr_planar(ar, ai, taur, taui, cr, ci, nb=128):
    """(cr, ci) <- Q @ (cr, ci) with Q from hetrd_planar (leading axes: a
    batch of problems)."""
    n = ar.shape[-1]
    nref = n - 1
    if nref <= 0:
        return cr, ci
    lead = ar.shape[:-2]
    nblocks = -(-nref // nb)
    pad = nblocks * nb - nref
    zpad = torch.zeros(lead + (pad,), dtype=taur.dtype, device=taur.device)
    tr = torch.cat([taur, zpad], -1).reshape(lead + (nblocks, nb))
    ti = torch.cat([taui, zpad], -1).reshape(lead + (nblocks, nb))
    extra = torch.zeros(lead + (n, nblocks * nb + 1 - n), dtype=ar.dtype, device=ar.device)
    ar_e = torch.cat([ar, extra], -1)
    ai_e = torch.cat([ai, extra], -1)

    with trace_range("unmtr_planar"):
        vs = [_block_v_planar(ar_e, ai_e, k * nb, nb, nref) for k in range(nblocks)]
        vr_all = torch.stack([v[0] for v in vs], -3)
        vi_all = torch.stack([v[1] for v in vs], -3)
        t_r_all, t_i_all = _larft_left_batched(vr_all, vi_all, tr, ti)
        for i in range(nblocks):
            vr, vi = vr_all[..., i, :, :], vi_all[..., i, :, :]
            t_r, t_i = t_r_all[..., i, :, :], t_i_all[..., i, :, :]
            # p = V^H C ; C -= V (T p)
            p_r = vr.mT @ cr + vi.mT @ ci
            p_i = vr.mT @ ci - vi.mT @ cr
            q_r = t_r @ p_r - t_i @ p_i
            q_i = t_r @ p_i + t_i @ p_r
            cr = cr - (vr @ q_r - vi @ q_i)
            ci = ci - (vr @ q_i + vi @ q_r)
        return cr, ci
