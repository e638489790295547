"""Blocked Householder tridiagonalization (sytrd/hetrd, UPLO='U'; twin of
eigensolver_gpu_tpu/ops/sytrd.py).

Reduces a symmetric/Hermitian ``A`` to real tridiagonal ``T = Q^H A Q``,
returning LAPACK-compatible results: ``d`` (diagonal), ``e``
(off-diagonal), ``tau`` and the Householder vectors packed in the upper
triangle (reflector ``r`` has ``v[0:r]`` stored in column ``r+1``,
``v[r] = 1``; ``Q = H(n-2) ... H(1) H(0)``).

Reference design (dsytrd_gpu.F90 / zhetrd_gpu.F90): panels of 32 columns
swept from the last column backwards; each panel column runs the fused
rank-2-update + larfg, the triangle-reading symv (dsymv_gpu.F90:33) and
the stacked gemvs, then a syr2k trailing update. As in the JAX package,
``A`` is kept full (mirrored), the sweep runs bucket by bucket from the
bottom-right, and one implementation serves real and complex dtypes.
With ``use_pallas=True`` the hot ``A v`` of real fp32 buckets whose size
is a multiple of 512 (the JAX gate) goes through the upper-tile symv
kernel (ops/symv.py), one launch a column for a whole batch.

Port differences: the working matrix is updated IN PLACE on views (each
bucket is ``a[:mb, :mb]`` of the symmetrized copy), and exact slices
replace the static-shape row masks -- ``v`` is zero from row cj on and
``w`` is masked to rows < cj, so the products run on the leading
cj x cj block only.

``mesh`` (a ('dp', 'tp') DeviceMesh, parallel/mesh.py) splits the rows of
the working matrix over 'tp', as JAX's row sharding does: rank r owns the
contiguous rows ``comm.row_range(n, mesh)`` of the whole matrix (of a
bucket, the part of them above its edge). Each panel's columns are
gathered from their owners (one all_gather a panel), the column chain
then runs on every rank (V and W replicated), each column's ``A v`` is
every rank's rows of the trailing block followed by one all_gather of the
n-vector (with ``use_pallas`` on fp32, the symv kernel over the rank's
diagonal block and two gemvs beside it), and the rank-2k trailing update
touches only the rank's own rows. The packed columns, d, e and tau come
out whole on every rank. Where the rows do not split evenly the mesh is
not used (JAX's ``_maybe_row_shard`` does nothing then).

Requires n % nb == 0 (drivers pad with a decoupled diagonal block).
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.symv import _mv, symv
from eigensolver_gpu_torch.parallel import comm
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _larfg(alpha, xnormsq, iscomplex):
    """Householder generator, LAPACK dlarfg/zlarfg conventions.

    Given pivot ``alpha`` and ||x||^2 of the entries above it (0-d
    tensors), returns (beta, tau, scale) with H = I - tau [v;1][v;1]^H,
    v = scale * x, H^H [x; alpha] = [0; beta], beta real. Branch-free:
    no value is read on the host.
    """
    if iscomplex:
        alphr, alphi = alpha.real, alpha.imag
    else:
        alphr, alphi = alpha, torch.zeros_like(alpha)
    norm = torch.sqrt(alphr * alphr + alphi * alphi + xnormsq)
    beta = torch.where(alphr >= 0, -norm, norm)
    trivial = (xnormsq == 0) & (alphi == 0)
    safe_beta = torch.where(trivial, torch.ones_like(beta), beta)
    if iscomplex:
        tau = torch.complex((beta - alphr) / safe_beta, -alphi / safe_beta)
    else:
        tau = (beta - alphr) / safe_beta
    denom = alpha - beta
    scale = 1.0 / torch.where(trivial, torch.ones_like(denom), denom)
    tau = torch.where(trivial, torch.zeros_like(tau), tau)
    scale = torch.where(trivial, torch.zeros_like(scale), scale)
    beta = torch.where(trivial, alphr, beta)
    return beta, tau, scale


def _vdot(x, y):
    """x^H y for vectors, or one an item for batches of them."""
    if x.dim() == 1:
        return torch.vdot(x, y)
    return (x.conj()[..., None, :] @ y[..., :, None])[..., 0, 0]


def _rows_mv(a, v, cj, lo, hi, use_pallas):
    """Rows lo:hi of A[:cj, :cj] v (zero past row cj), A the whole working
    matrix whose rows lo:hi are current: a (hi - lo)-vector. With
    ``use_pallas`` the rank's diagonal block goes through the symv kernel
    and the blocks beside it through gemvs."""
    y = v.new_zeros(v.shape[:-1] + (hi - lo,))
    top = min(hi, cj)
    if top <= lo:
        return y
    if not use_pallas:
        y[..., : top - lo] = _mv(a[..., lo:top, :cj], v)
        return y
    y[..., : top - lo] = symv(a[lo:top, lo:top], v[lo:top])
    if lo > 0:
        y[: top - lo] += a[lo:top, :lo] @ v[:lo]
    if cj > top:
        y[: top - lo] += a[lo:top, top:cj] @ v[top:cj]
    return y


def _panel_columns(a_mb, d, e, tau, panel_end, nb, use_pallas=False, shard=None):
    """dlatrd-equivalent: process the nb columns [panel_end-nb, panel_end)
    in descending order. Writes the packed columns into ``a_mb`` and the
    scalars into d, e, tau in place; returns the compact-WY panels
    (v_p, w_p), (mb, nb), slot k = column panel_end-1-k. Leading axes are
    a batch of problems (per-item scalars are tensors of the batch shape);
    ``use_pallas`` runs each column's ``A v`` as one symv launch for the
    batch. ``shard`` =
    (a, lo, hi, mesh): each ``A v`` is rows lo:hi of the whole working
    matrix ``a`` times v, gathered over the mesh's 'tp' ranks.

    The panels live side by side in two stacked buffers, vw = [V W] and
    wv = [W V], so each of the reference's stacked gemv pairs
    (dsytrd_gpu.F90:449, 511, 618) is one product; unfilled slots are
    zero columns.
    """
    mb = a_mb.shape[-1]
    iscomplex = a_mb.is_complex()
    vw = torch.zeros(a_mb.shape[:-2] + (mb, 2 * nb), dtype=a_mb.dtype, device=a_mb.device)
    wv = torch.zeros_like(vw)
    for k in range(nb):
        cj = panel_end - 1 - k  # absolute column being reduced
        # rank-2 correction from this panel's already-computed columns
        # (dlatrd's leading gemv pair; zlatrd conjugates the row picks)
        a_col = a_mb[..., :, cj] - _mv(vw, wv[..., cj, :].conj())
        d_val = a_col[..., cj].real.clone()
        d[..., cj] = d_val
        if cj == 0:  # no reflector: only the diagonal entry is left
            a_col[..., 0] = d_val
            a_mb[..., :, 0] = a_col
            break
        # Householder generation for rows [0, cj): pivot at row cj-1
        x = a_col[..., : cj - 1]
        if iscomplex:
            xnormsq = torch.sum(x.real * x.real + x.imag * x.imag, dim=-1)
        else:
            xnormsq = x @ x if x.dim() == 1 else torch.sum(x * x, dim=-1)
        beta, tau_k, scale = _larfg(a_col[..., cj - 1], xnormsq, iscomplex)
        v = a_col[..., :cj] * scale[..., None]
        v[..., cj - 1] = 1.0

        # w = tau * (A v - V (W^H v) - W (V^H v)), then the -1/2 tau
        # (w^H v) v correction (dlatrd tail). A v is the flops-dominant
        # product of the whole reduction (the reference's dsymv_gpu).
        if shard is not None:
            a_all, lo, hi, mesh = shard
            y = comm.all_gather(_rows_mv(a_all, v, cj, lo, hi, use_pallas), mesh, axis=-1,
                                what="sytrd")[..., :cj]
        elif use_pallas:
            y = symv(a_mb, v, extent=cj)
        else:
            y = _mv(a_mb[..., :cj, :cj], v)
        y = y - _mv(vw[..., :cj, :], _mv(wv[..., :cj, :].mH, v))
        w = tau_k[..., None] * y
        w = w + (-0.5 * tau_k * _vdot(w, v))[..., None] * v
        vw[..., :cj, k] = v
        wv[..., :cj, nb + k] = v
        vw[..., :cj, nb + k] = w
        wv[..., :cj, k] = w

        # column cj in LAPACK storage: v in rows [0, cj-1), e (= beta) at
        # row cj-1, the updated diagonal at row cj
        a_col[..., :cj] = v
        a_col[..., cj - 1] = beta
        a_col[..., cj] = d_val
        a_mb[..., :, cj] = a_col
        e[..., cj - 1] = beta
        tau[..., cj - 1] = tau_k
    return vw[..., :, :nb], vw[..., :, nb:]


@highest_precision
def sytrd_blocked(a, nb=32, bucket=512, use_pallas=False, mesh=None):
    """Full blocked tridiagonalization. Returns (a_packed, d, e, tau).
    Leading axes of ``a`` are a batch of problems, reduced together
    column by column (with ``use_pallas``, one symv launch a column for the
    batch, which takes one batch axis).
    ``mesh``: split the rows over its 'tp' ranks (module docstring)."""
    n = a.shape[-1]
    if n % nb != 0:
        raise ValueError(f"sytrd_blocked requires n % nb == 0, got n={n}, nb={nb}")
    lead = a.shape[:-2]
    dtype = a.dtype
    iscomplex = a.is_complex()
    rdtype = a.real.dtype

    # full mirrored storage: symmetrize and (complex) force a real diagonal;
    # row-major whatever the input's layout (the symv kernel and the
    # bucket views need unit column stride)
    a = ((a + a.mH) / 2).contiguous()

    d = torch.zeros(lead + (n,), dtype=rdtype, device=a.device)
    e = torch.zeros(lead + (max(n - 1, 1),), dtype=rdtype, device=a.device)
    tau = torch.zeros(lead + (max(n - 1, 1),), dtype=dtype, device=a.device)

    rows = comm.row_range(n, mesh)
    with trace_range("sytrd"):
        num_buckets = -(-n // bucket)
        for b in range(num_buckets, 0, -1):
            mb = min(b * bucket, n)
            lo = (b - 1) * bucket
            a_mb = a[..., :mb, :mb]  # view: updated in place
            # the JAX gate (its Pallas symv is fp32-only with 2 x 256
            # tiles); kept so both packages take the same branch
            kernel_ok = (
                use_pallas and not iscomplex and dtype == torch.float32 and mb % 512 == 0
            )
            for p in range((mb - lo) // nb):
                panel_end = mb - p * nb
                t = panel_end - nb
                if rows is None:
                    v_p, w_p = _panel_columns(a_mb, d, e, tau, panel_end, nb, kernel_ok)
                    # trailing rank-2nb update A -= V W^H + W V^H on the
                    # leading t x t block (syr2k/her2k in the reference)
                    upd = v_p[..., :t, :] @ w_p[..., :t, :].mH
                    a_mb[..., :t, :t] -= upd + upd.mH
                    continue
                r0, r1 = rows
                # the panel's columns, whole, from the ranks that own their rows
                a[..., :mb, t:panel_end] = comm.all_gather(
                    a[..., r0:r1, t:panel_end], mesh, what="sytrd")[..., :mb, :]
                v_p, w_p = _panel_columns(a_mb, d, e, tau, panel_end, nb, kernel_ok,
                                          shard=(a, r0, r1, mesh))
                top = min(r1, t)
                if top > r0:  # the update of the rank's own rows
                    a_mb[..., r0:top, :t] -= (v_p[..., r0:top, :] @ w_p[..., :t, :].mH
                                              + w_p[..., r0:top, :] @ v_p[..., :t, :].mH)

    ne = n - 1 if n > 1 else 0
    return a, d, e[..., :ne], tau[..., :ne]


def sytrd(a, nb=32, bucket=512, use_pallas=False, mesh=None):
    """Alias used by the drivers (real and complex share one
    implementation)."""
    return sytrd_blocked(a, nb=nb, bucket=bucket, use_pallas=use_pallas, mesh=mesh)
