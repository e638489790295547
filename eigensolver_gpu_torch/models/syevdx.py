"""Standard symmetric/Hermitian eigensolver with index-range selection
(twin of eigensolver_gpu_tpu/models/syevdx.py).

Pipeline (reference dsyevd_gpu.F90:32-128 / zheevd_gpu.F90:32-130):
tridiagonalize -> tridiagonal eigensolve -> select columns il..iu ->
back-transform. As in the JAX package, the tridiagonal solve runs on the
device (ops/stedc.py) instead of a host LAPACK call, and A is not
destroyed.

For Hermitian input the tridiagonal matrix is real; the real stedc
output is cast back to the complex dtype only for the WY back-transform.

The two-stage reduction (ops/sbrd.py -> ops/sb2st.py, replayed by
``apply_q2`` then ``apply_q1``) follows the JAX rule: real input with
``tridiag_mode='two'``, or ``'auto'`` with fp64 compute at
n >= ``two_stage_min_n``; complex input is one-stage in every mode. The
JAX ``'auto'`` rule for fp32 compute is "n >= 8192 on a TPU backend",
false on every other backend, so fp32 ``'auto'`` stays one-stage here.
With ``cfg.mosaic_kernels`` (the default) the panel, the chase and the
replay go through their kernel wrappers (K5, K7, K9 on CUDA tensors,
the plain versions on CPU tensors); without it they take the plain torch
functions. There is no probe and no fallback: a kernel that cannot take
its arguments raises. ``mesh`` (row sharding) is not carried.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.refine import refine_eigh
from eigensolver_gpu_torch.ops.stedc import stedc
from eigensolver_gpu_torch.ops.sytrd import sytrd
from eigensolver_gpu_torch.ops.unmtr import unmtr
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _pad_decoupled(a, npad):
    """Embed A in an npad x npad matrix whose extra block is a decoupled
    diagonal strictly above A's spectrum (Gershgorin bound), so the padded
    eigenvalues sort after the real ones and index selection is unchanged.
    Tight spacing: the pad values feed stedc's scaling, and a wide ramp
    inflates its fp32 deflation thresholds."""
    n = a.shape[0]
    if npad == n:
        return a
    bound = torch.max(torch.sum(a.abs(), dim=1)) + 1.0
    k = npad - n
    padvals = bound * (
        2.0 + torch.arange(k, dtype=bound.dtype, device=a.device) * (1.0 / 256.0)
    )
    out = torch.zeros((npad, npad), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[idx, idx] = padvals.to(a.dtype)
    return out


def _use_two_stage(n, cfg, iscomplex, compute_is_f64):
    """Whether the two-stage reduction (sbrd + bulge chase) replaces the
    one-stage Householder loop: the JAX package's rule (see the module
    docstring), its thresholds not re-tuned for this card."""
    if iscomplex or cfg.tridiag_mode == "one":
        return False
    if cfg.tridiag_mode == "two":
        return True
    return compute_is_f64 and n >= cfg.two_stage_min_n


def _tridiag_reduce(a_p, cfg, two_stage):
    """Reduce symmetric/Hermitian ``a_p`` (padded) to tridiagonal (d, e);
    returns (d, e, back) with ``back(z)`` applying the accumulated
    orthogonal transform Q to tridiagonal eigenvector columns z."""
    if two_stage:
        from eigensolver_gpu_torch.ops.sb2st import apply_q2, bulge_chase, dense_to_band
        from eigensolver_gpu_torch.ops.sbrd import apply_q1, sbrd

        npad = a_p.shape[0]
        ab, vs, ts = sbrd(a_p, band=cfg.band, bucket=512, panel_kernel=cfg.mosaic_kernels)
        band = dense_to_band(ab, cfg.band)
        if cfg.mosaic_kernels:
            from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel

            d, e, vt, taut = bulge_chase_kernel(band, cfg.band)
        else:
            d, e, vt, taut = bulge_chase(band, cfg.band)
        # replay group size: the JAX default, 3*band in fp32 (l_win = 127
        # at band 32) and band in fp64
        g = cfg.replay_g or (3 * cfg.band if ab.dtype == torch.float32 else cfg.band)

        def back(z):
            if cfg.mosaic_kernels:
                from eigensolver_gpu_torch.ops.replay import apply_q2_kernel

                z2 = apply_q2_kernel(vt, taut, z, npad, cfg.band, g=g)
            else:
                z2 = apply_q2(vt, taut, z, npad, cfg.band, g=g)
            return apply_q1(vs, ts, z2)

        return d, e, back

    a_packed, d, e, tau = sytrd(
        a_p, nb=cfg.nb_tridiag, bucket=256, use_pallas=cfg.use_pallas
    )

    def back(z):
        return unmtr(a_packed, tau, z, nb=cfg.nb_back)

    return d, e, back


@highest_precision
def syevdx(a, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Eigenpairs il..iu (1-based, ascending, LAPACK RANGE='I') of dense
    symmetric/Hermitian ``a``. Returns (w (m,) real, z (n, m)), on the
    device of ``a``."""
    n = a.shape[0]
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"need 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
    iscomplex = a.is_complex()

    if cfg.stedc_backend == "xla":
        with trace_range("syevdx_xla"):
            w, z = torch.linalg.eigh(a)
            return w[il - 1 : iu], z[:, il - 1 : iu]

    rdt = a.real.dtype
    mixed = cfg.compute_dtype == "float32" and rdt == torch.float64
    two_stage = _use_two_stage(n, cfg, iscomplex, rdt == torch.float64 and not mixed)
    nb = cfg.band if two_stage else cfg.nb_tridiag
    npad = -(-n // nb) * nb
    if two_stage and npad < 3 * cfg.band:
        two_stage = False
        nb = cfg.nb_tridiag
        npad = -(-n // nb) * nb

    if mixed:
        # O(n^3) factorization stages in fp32, then Ogita-Aishima sweeps
        # against the fp64 matrix recover fp64 accuracy (ops/refine.py).
        # The fp32 pipeline computes the full spectrum (stedc needs it);
        # refinement runs on the selected block + cluster margin only.
        lo_dt = torch.complex64 if iscomplex else torch.float32
        a_p = _pad_decoupled(a.to(lo_dt), npad)
        with trace_range("syevdx_fp32"):
            d, e, back = _tridiag_reduce(a_p, cfg, two_stage)
            w_all, q_tri = stedc(d, e, leaf=cfg.stedc_leaf)
            z_tri = q_tri.to(lo_dt) if iscomplex else q_tri
            x32 = back(z_tri[:, :n])[:n]
        sel0 = max(0, il - 1 - cfg.refine_margin)
        sel1 = min(n, iu + cfg.refine_margin)
        w, x = refine_eigh(
            a, x32.to(a.dtype), sweeps=cfg.refine_iters,
            chunk=2048 if n >= 8192 else None,
            sel=(sel0, sel1 - sel0), w0=w_all[:n].to(rdt),
            extra_max=cfg.refine_extra_max,
        )
        order = torch.argsort(w, stable=True)
        w = w[order]
        x = x[:, order]
        lo = il - 1 - sel0
        return w[lo : lo + (iu - il + 1)], x[:, lo : lo + (iu - il + 1)]

    a_p = _pad_decoupled(a, npad)
    with trace_range("syevdx"):
        d, e, back = _tridiag_reduce(a_p, cfg, two_stage)
        w_all, q_tri = stedc(d, e, leaf=cfg.stedc_leaf)
        # the decoupled padding sorts above the true spectrum, so indices
        # il..iu of the first n entries are the requested pairs
        w = w_all[il - 1 : iu]
        z_tri = q_tri[:, il - 1 : iu]
        if iscomplex:
            z_tri = z_tri.to(a.dtype)
        return w, back(z_tri)[:n]
