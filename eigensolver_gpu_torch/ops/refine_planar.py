"""Planar mixed-precision refinement for the generalized eigenproblem
(twin of eigensolver_gpu_tpu/ops/refine_planar.py).

With R = I - X^H B X and S = X^H A X the first-order Ogita-Aishima
corrections are

    E_ii = R_ii / 2
    E_ij = (S_ij + lambda_j R_ij) / (lambda_j - lambda_i)   (separated)
    E_ij = R_ij / 2                                          (clustered)
    X <- X + X E

so the whole fp32 planar pipeline is refined against the fp64 A and B
with a handful of planar gemms. Only a selected block of columns (the
range il..iu plus a cluster-guard margin) is corrected, against the
full fp32 basis. Each fp64 sweep also returns a ``defect``, the
predicted post-sweep coupling of marginally separated pairs; while it
exceeds the residual contract, up to ``extra_max`` more fp64 sweeps run.
See the JAX twin's docstring for the derivations.

``gemm='native'``, the port's default and the card's, runs the fp64
products as native fp64 ``torch.matmul``. ``gemm='ozaki'``, the JAX
package's default (a workaround for its emulated fp64), runs the fp64
sweeps as exact digit gemms (ops/ozaki.py) with X's slicings reused across
the four products of a sweep (``_sweep_ozaki``), or, with ``chunk``, the
chunked ozaki products. Which route the card should take by default is for
a benchmark to decide.
"""

from __future__ import annotations

import functools

import torch

from eigensolver_gpu_torch.ops.ozaki import (
    digit_bits_for,
    nslice_for,
    ozaki_planar_slices,
    ozaki_pmatmul,
    ozaki_pmatmul_chunked,
    ozaki_pmatmul_pre,
    ozaki_slice,
)
from eigensolver_gpu_torch.ops.planar import pH, pmatmul, pmatmul_chunked
from eigensolver_gpu_torch.ops.refine import _check_gemm, escalate
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range

_EPS32 = torch.finfo(torch.float32).eps


def _renorm_planar(m, e, sel0, ms):
    """Second-order B-norm column scales 1/sqrt(diag((I+E)^H M (I+E)))
    from the gram M = X^H B X_sel and the correction E, gemm-free."""
    d = (
        torch.diagonal(m[0][..., sel0 : sel0 + ms, :], dim1=-2, dim2=-1)
        + 2.0 * torch.sum(e[0] * m[0] + e[1] * m[1], dim=-2)
        + torch.sum(e[0] * e[0] + e[1] * e[1], dim=-2)
    )
    return 1.0 / torch.sqrt(torch.clamp_min(d, torch.finfo(d.dtype).tiny))


def _correct_block(xhbx, s, sel0, ms, w_rows):
    """From the grams xhbx = X^H B Xs and s = X^H A Xs ((n_all, ms)
    planar pairs, leading axes a batch) build the correction E, the
    column scales, the updated eigenvalue estimates and the marginal-pair
    defect (one an item).

    Returns (e, sc, lam_sel, w_rows', defect)."""
    dt = xhbx[0].dtype
    dev = xhbx[0].device
    n_all = xhbx[0].shape[-2]
    eps = torch.finfo(dt).eps
    rows = torch.arange(n_all, device=dev)[:, None]
    cols = torch.arange(ms, device=dev)[None, :]
    is_self = rows == cols + sel0
    inblk = (rows >= sel0) & (rows < sel0 + ms)

    r = (is_self.to(dt) - xhbx[0], -xhbx[1])
    lam_sel = torch.diagonal(s[0][..., sel0 : sel0 + ms, :], dim1=-2, dim2=-1) / (
        1.0 - torch.diagonal(r[0][..., sel0 : sel0 + ms, :], dim1=-2, dim2=-1)
    )
    w_rows = w_rows.clone()
    w_rows[..., sel0 : sel0 + ms] = lam_sel
    denom = lam_sel[..., None, :] - w_rows[..., :, None]
    anorm = w_rows.abs().amax(-1)[..., None, None]  # one an item
    sep_in = torch.clamp_min(1e3 * eps * anorm, _EPS32 * anorm)
    # out-of-block lambdas carry the fp32 pipeline's O(eps32*anorm)
    # error: denominators below ~64x that cannot be trusted as separated
    sep = torch.where(inblk, sep_in, torch.clamp_min(sep_in, 64 * _EPS32 * anorm))
    ok = denom.abs() > sep
    safe = torch.where(ok, denom, 1.0)
    num_r = s[0] + lam_sel[..., None, :] * r[0]
    num_i = s[1] + lam_sel[..., None, :] * r[1]
    e = (
        torch.where(ok, num_r / safe, r[0] / 2),
        torch.where(ok, num_i / safe, r[1] / 2),
    )
    sc = _renorm_planar(xhbx, e, sel0, ms)[..., None, :]
    # defect = predicted post-sweep residual; cluster-branch pairs are
    # suppressed via max(.., sep)
    delta = torch.where(inblk, 1e3 * eps * anorm, 64 * _EPS32 * anorm)
    absnum = torch.sqrt(num_r * num_r + num_i * num_i)
    pred = torch.where(
        is_self,
        0.0,
        torch.minimum(absnum, (delta + absnum) * absnum / torch.maximum(denom.abs(), sep)),
    )
    defect = torch.sqrt(torch.amax(torch.sum(pred * pred, dim=-2), dim=-1))
    return e, sc, lam_sel, w_rows, defect


def _update(x, sel, dx, sc):
    """x with block columns sel0..sel0+ms replaced by (x_blk + dx) * sc."""
    sel0, ms = sel
    xr, xi = x[0].clone(), x[1].clone()
    xr[..., sel0 : sel0 + ms] = (x[0][..., sel0 : sel0 + ms] + dx[0]) * sc
    xi[..., sel0 : sel0 + ms] = (x[1][..., sel0 : sel0 + ms] + dx[1]) * sc
    return xr, xi


def _sweep(a, b, x, sel, w_rows, chunk=None, mm=pmatmul_chunked, mm_dx=None):
    """One Ogita-Aishima sweep on the selected block, in the dtype of its
    arguments. ``x`` is the full planar basis (n, n_all); only columns
    sel0..sel0+ms change. ``mm(x, y, chunk)`` is the planar product,
    ``mm_dx`` (default ``mm``) the correction's X @ E.
    Returns (x', lam_sel, w_rows', defect)."""
    sel0, ms = sel
    xr, xi = x
    xs = (xr[..., sel0 : sel0 + ms], xi[..., sel0 : sel0 + ms])
    bx = mm(b, xs, chunk)
    ax = mm(a, xs, chunk)
    xhbx = mm(pH(x), bx, chunk)
    s = mm(pH(x), ax, chunk)
    e, sc, lam_sel, w_rows, defect = _correct_block(xhbx, s, sel0, ms, w_rows)
    dx = (mm_dx or mm)(x, e, chunk)
    return _update(x, sel, dx, sc), lam_sel, w_rows, defect


def _sweep_ozaki(a, b, x, sel, w_rows, bits=48):
    """fp64 selected-block sweep with slice-reused ozaki products: the same
    math as _sweep; X's column slicings are made once and serve B @ Xs and
    A @ Xs (the block's columns are a slice of them, per-column scales
    slice with them) and both grams (as the transposed lhs: X^T's row
    scales are X's column scales)."""
    sel0, ms = sel
    xr, xi = x
    n = a[0].shape[-1]
    dbits = digit_bits_for(n)
    ns = nslice_for(dbits, bits)

    xcol = ozaki_planar_slices((xr, xi), 1, dbits, ns)
    blk = lambda p: (p[0][..., sel0 : sel0 + ms], p[1][..., sel0 : sel0 + ms])
    xcol_s = tuple(blk(p) for p in xcol)
    bx = ozaki_pmatmul_pre(ozaki_planar_slices(b, 0, dbits, ns), xcol_s, dbits)
    ax = ozaki_pmatmul_pre(ozaki_planar_slices(a, 0, dbits, ns), xcol_s, dbits)
    # X^H @ BX and X^H @ AX: X's column slicings as the transposed lhs
    xconj = (xcol[0], xcol[1], ozaki_slice(xr - xi, 1, dbits, ns))
    xhbx = ozaki_pmatmul_pre(xconj, ozaki_planar_slices(bx, 1, dbits, ns), dbits,
                             transpose_lhs=True, conj_lhs=True)
    s = ozaki_pmatmul_pre(xconj, ozaki_planar_slices(ax, 1, dbits, ns), dbits,
                          transpose_lhs=True, conj_lhs=True)
    e, sc, lam_sel, w_rows, defect = _correct_block(xhbx, s, sel0, ms, w_rows)
    # the correction needs ~28 bits relative to E: its error stays below
    # the sweep's own quadratic O(|E|^2) term (4 digit slices, not 7)
    dx = ozaki_pmatmul((xr, xi), e, bits=28)
    return _update(x, sel, dx, sc), lam_sel, w_rows, defect


@highest_precision
def refine_gevp_planar(
    a, b, x, sweeps=2, coarse_first=True, final_pass=False, chunk=None,
    gemm="native", sel=None, w0=None, extra_max=0,
):
    """Refine planar eigenvectors ``x`` (n, m), the full approximate basis
    in ascending eigenvalue order, of the pair (a, b).

    sel: (sel0, ms) -- refine only block columns sel0..sel0+ms; returns
    (w (ms,), x_block (n, ms)). None refines and returns everything.
    w0: full-length eigenvalue estimates from the fp32 pipeline, required
    when sel selects a strict subset.
    coarse_first: run all but the last sweep (at most 2) in fp32.
    final_pass: after the last update (the escalation included), take the
    Rayleigh quotients and B-norms of the returned block from two more
    planar products in x's precision (``pmatmul``, native on the card
    whatever ``gemm`` is, as JAX's are its platform fp64 dot): w = x^H A x
    / x^H B x (x^H A x where the B-norm is 0) and each column scaled to
    B-norm 1. Off by default, as in JAX: the last sweep's w is already
    quadratically accurate and its B-norms 1 + O(err^2).
    extra_max: at most this many extra fp64 sweeps while the defect
    exceeds 100 * eps64 * sqrt(n) * anorm. The test reads the defect on
    the host: one device sync per sweep.
    Leading axes of a, b, x (and w0) are a batch of problems: each item
    has its own tolerance and escalates on its own (ops/refine.escalate).
    gemm: 'native' (the default, here and on the card: fp64
    torch.matmul) or 'ozaki' (the JAX default: the fp64 sweeps as exact
    digit gemms, ops/ozaki.py; the coarse fp32 sweeps stay plain);
    anything else is a ValueError.
    """
    _check_gemm(gemm)
    ar, _ = a
    xr, xi = x
    n, m = xr.shape[-2:]
    if sel is None:
        sel = (0, m)
    sel0, ms = sel
    f64 = ar.dtype == torch.float64
    if w0 is None:
        if ms < m:
            raise ValueError("sel with a strict subset requires w0")
        w0 = torch.zeros(xr.shape[:-2] + (m,), dtype=ar.dtype, device=ar.device)
    w_rows = w0.to(ar.dtype)

    with trace_range("refine_gevp_planar"):
        if coarse_first and sweeps > 1 and f64:
            f32 = lambda p: (p[0].float(), p[1].float())
            a32, b32 = f32(a), f32(b)
            x32 = f32((xr, xi))
            w32 = w_rows.float()
            n_coarse = min(sweeps - 1, 2)
            for _ in range(n_coarse):
                x32, _, w32, _ = _sweep(a32, b32, x32, sel, w32)
            xr, xi = x32[0].to(ar.dtype), x32[1].to(ar.dtype)
            w_rows = w32.to(ar.dtype)
            n_f64_sweeps = max(sweeps - n_coarse, 1)
        else:
            n_f64_sweeps = sweeps

        use_ozaki = gemm == "ozaki" and f64

        def sweep(xpair, w_rows):
            if use_ozaki and chunk is None:
                return _sweep_ozaki(a, b, xpair, sel, w_rows)
            if use_ozaki:
                return _sweep(a, b, xpair, sel, w_rows, chunk, ozaki_pmatmul_chunked,
                              functools.partial(ozaki_pmatmul_chunked, bits=28))
            return _sweep(a, b, xpair, sel, w_rows, chunk)

        w = None
        defect = None
        for _ in range(n_f64_sweeps):
            (xr, xi), w, w_rows, defect = sweep((xr, xi), w_rows)

        if extra_max > 0 and f64:
            anorm = w_rows.abs().amax(-1)
            tol = 100.0 * torch.finfo(torch.float64).eps * (n**0.5) * anorm

            def one_sweep(state):
                xr, xi, w_rows = state
                (xr, xi), _, w_rows, defect = sweep((xr, xi), w_rows)
                return (xr, xi, w_rows), defect

            (xr, xi, w_rows), defect = escalate(one_sweep, (xr, xi, w_rows), defect, tol,
                                                extra_max)
            w = w_rows[..., sel0 : sel0 + ms]

        xs = (xr[..., sel0 : sel0 + ms], xi[..., sel0 : sel0 + ms])
        if not final_pass:
            return w, xs
        bx = pmatmul(b, xs)
        ax = pmatmul(a, xs)
        bnorm = torch.sum(xs[0] * bx[0] + xs[1] * bx[1], dim=-2)
        anum = torch.sum(xs[0] * ax[0] + xs[1] * ax[1], dim=-2)
        w = anum / torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
        scale = 1.0 / torch.sqrt(torch.clamp_min(bnorm, torch.finfo(bnorm.dtype).tiny))
        return w, (xs[0] * scale[..., None, :], xs[1] * scale[..., None, :])
