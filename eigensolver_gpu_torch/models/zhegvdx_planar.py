"""Planar complex generalized eigensolver (twin of
eigensolver_gpu_tpu/models/zhegvdx_planar.py): zhegvdx,
A x = lambda B x with LAPACK ITYPE=1, JOBZ='V', RANGE='I', UPLO='U', on
(re, im) real pairs.

The reference's 5-phase pipeline (zhegvdx_gpu.F90:131-180):

  1. B = L L^H               planar blocked Cholesky (ops/planar.py,
                             diagonal blocks by kernel K1 in fp32)
  2. C = L^{-1} A L^{-H}     two planar triangular solves
  3. hetrd_planar -> real (d, e) -> stedc -> select il..iu
     -> unmtr_planar back-transform   (kernel K2 with use_pallas=True);
     or, two-stage: psbrd (kernel K6 per panel) -> planar bulge chase
     (K8) -> phase_normalize -> stedc -> Q2 replay (K10) -> Q1 replay
  4. x = L^{-H} y            planar upper solve
  5. results stay on the device as planar pairs

With ``SolverConfig(compute_dtype='float32')`` and fp64 inputs the
pipeline runs in fp32 and the selected block is refined in fp64
(ops/refine_planar.py). Entry points run on the device of their inputs:
CUDA tensors for the card, CPU tensors for the tests.

The two-stage reduction (ops/sbrd_planar.py -> ops/sb2st_planar.py)
follows the JAX shape rules: ``tridiag_mode='two'`` engages it when the
padded size is a multiple of ``cfg.band`` and at least ``3 * cfg.band``,
else the one-stage branch runs. ``'auto'`` stays one-stage: the size at
which it should switch on this card waits for a benchmark's numbers
(``cfg.planar_two_stage_min_n`` is kept in the config and not read). With
``cfg.mosaic_kernels`` (the default) the Cholesky blocks, the panel, the
chase and the replay go through their kernel wrappers (K1, K6, K8, K10 on
CUDA tensors, the plain versions on CPU tensors); without it they take the
plain torch functions. There is no probe and no fallback: a kernel that
cannot take its arguments raises. So a replay window past the kernel's 128
rows (``band + g - 1 > 128``, for example band 64 in fp32 with the default
g) is a ValueError under ``mosaic_kernels``: set ``replay_g`` to at most
``129 - band``, or take the plain route with ``mosaic_kernels=False``.

Not ported yet: ``planar_solve_mode='trinv'`` and
``zhegvdx_planar_batched``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eigensolver_gpu_torch.ops.planar import (
    pcholesky_lower,
    pH,
    ptrsm_left_lower,
    ptrsm_left_lower_inv,
    ptrsm_left_upper,
)
from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
from eigensolver_gpu_torch.ops.stedc import stedc
from eigensolver_gpu_torch.ops.sytrd_planar import hetrd_planar
from eigensolver_gpu_torch.ops.unmtr_planar import unmtr_planar
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.convert import planar_from_numpy
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


class PlanarResult(NamedTuple):
    w: torch.Tensor
    zr: torch.Tensor
    zi: torch.Tensor
    info: torch.Tensor


def _from_upper_planar(xr, xi):
    """Rebuild the Hermitian planar pair from its upper triangle (UPLO='U':
    the strict lower triangle may hold anything)."""
    upr = torch.triu(xr, 1)
    upi = torch.triu(xi, 1)
    return upr + upr.T + torch.diag(torch.diagonal(xr)), upi - upi.T


def _pad_planar(ar, ai, npad):
    """Pad to npad with decoupled diagonal entries above the spectrum
    (tightly spaced: wide ramps inflate stedc's fp32 deflation
    thresholds)."""
    n = ar.shape[0]
    if npad == n:
        return ar, ai
    bound = torch.max(torch.sum(torch.sqrt(ar * ar + ai * ai), dim=1)) + 1.0
    k = npad - n
    padvals = bound * (
        2.0 + torch.arange(k, dtype=ar.dtype, device=ar.device) * (1.0 / 256.0)
    )
    out_r = torch.zeros((npad, npad), dtype=ar.dtype, device=ar.device)
    out_i = torch.zeros_like(out_r)
    out_r[:n, :n] = ar
    out_i[:n, :n] = ai
    idx = torch.arange(n, npad, device=ar.device)
    out_r[idx, idx] = padvals
    return out_r, out_i


def _tri_eigh(d, e, cfg):
    """Tridiagonal eigensolve per cfg.stedc_backend: 'dc' = on-device
    divide and conquer, 'xla' = dense eigh of the tridiagonal."""
    if cfg.stedc_backend == "xla":
        return torch.linalg.eigh(torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1))
    return stedc(d, e, leaf=cfg.stedc_leaf)


def _two_stage_planar(cr_p, ci_p, il, iu, cfg):
    """PHASE 3 by the two-stage reduction: returns (w, (yr, yi)) with the
    eigenvector chain y = Q1 Q2 D z_tri (D from phase_normalize)."""
    from eigensolver_gpu_torch.ops.sb2st import dense_to_band
    from eigensolver_gpu_torch.ops.sb2st_planar import (
        apply_q2_planar,
        bulge_chase_planar,
        phase_normalize,
    )
    from eigensolver_gpu_torch.ops.sbrd_planar import apply_q1_planar, psbrd

    npad, band = cr_p.shape[0], cfg.band
    (abr, abi), vs, ts = psbrd(cr_p, ci_p, band=band, bucket=512,
                               panel_kernel=cfg.mosaic_kernels)
    band_r = dense_to_band(abr, band)
    band_i = dense_to_band(abi, band)
    if cfg.mosaic_kernels:
        from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel

        d, (e_r, e_i), vt, taut = bulge_chase_planar_kernel(band_r, band_i, band)
    else:
        d, (e_r, e_i), vt, taut = bulge_chase_planar(band_r, band_i, band)
    (p_r, p_i), e_abs = phase_normalize(e_r, e_i)
    w_all, q_tri = _tri_eigh(d, e_abs, cfg)
    z0 = q_tri[:, il - 1 : iu]
    y0 = (z0 * p_r[:, None], z0 * p_i[:, None])
    # replay group size: the JAX default, 3*band in fp32 (l_win = 127 at
    # band 32) and band in fp64
    g = cfg.replay_g or (3 * band if cr_p.dtype == torch.float32 else band)
    if cfg.mosaic_kernels:
        from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel

        y = apply_q2_planar_kernel(vt, taut, y0, npad, band, g=g)
    else:
        y = apply_q2_planar(vt, taut, y0, npad, band, g=g)
    return w_all[il - 1 : iu], apply_q1_planar(vs, ts, y)


def _check_ported(cfg):
    if cfg.planar_solve_mode == "trinv":
        raise NotImplementedError(
            "planar_solve_mode='trinv' (ptrinv_lower) is not ported yet"
        )


@highest_precision
def zhegvdx_planar(ar, ai, br, bi, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Planar A x = lambda B x, eigenpairs il..iu (1-based).

    Returns PlanarResult(w, zr, zi, info) with info the cuSOLVER devInfo
    of the Cholesky of B (0 on success, else the 1-based column of the
    first non-positive pivot), as an int32 0-d tensor on the device."""
    n = ar.shape[0]
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"require 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
    _check_ported(cfg)
    nb_chol = min(128, n)

    # UPLO='U' contract: only the upper triangles are read.
    ar, ai = _from_upper_planar(ar, ai)
    br, bi = _from_upper_planar(br, bi)

    if cfg.compute_dtype == "float32" and ar.dtype == torch.float64:
        # fp32 full-spectrum pipeline + fp64 generalized refinement of the
        # selected block (plus the cluster-guard margin)
        f32 = lambda v: v.float()
        w32, zr32, zi32, info = zhegvdx_planar(
            f32(ar), f32(ai), f32(br), f32(bi), il=1, iu=n,
            cfg=SolverConfig(
                nb_tridiag=cfg.nb_tridiag, nb_back=cfg.nb_back,
                stedc_leaf=cfg.stedc_leaf,
                stedc_backend=cfg.stedc_backend,
                use_pallas=cfg.use_pallas,
                tridiag_mode=cfg.tridiag_mode, band=cfg.band,
                replay_g=cfg.replay_g,
                planar_solve_mode=cfg.planar_solve_mode,
                mosaic_kernels=cfg.mosaic_kernels,
            ),
        )
        x64 = (zr32.to(ar.dtype), zi32.to(ar.dtype))
        chunk = 2048 if n >= 8192 else None
        sel0 = max(0, il - 1 - cfg.refine_margin)
        sel1 = min(n, iu + cfg.refine_margin)
        w, (zr, zi) = refine_gevp_planar(
            (ar, ai), (br, bi), x64, sweeps=cfg.refine_iters, chunk=chunk,
            sel=(sel0, sel1 - sel0), w0=w32.to(ar.dtype),
            extra_max=cfg.refine_extra_max,
        )
        order = torch.argsort(w, stable=True)
        w, zr, zi = w[order], zr[:, order], zi[:, order]
        lo = il - 1 - sel0
        hi = lo + (iu - il + 1)
        return PlanarResult(w=w[lo:hi], zr=zr[:, lo:hi], zi=zi[:, lo:hi], info=info)

    # fp32: diagonal-block-inverted solves (n/nb sequential steps; the
    # fp64 refinement absorbs the eps32 * kappa forward error); fp64 or
    # 'subst': pure substitution
    if ar.dtype == torch.float32 and cfg.planar_solve_mode != "subst":
        _solve_l = ptrsm_left_lower_inv
    else:
        _solve_l = ptrsm_left_lower

    with trace_range("zhegvdx_planar"):
        l, info = pcholesky_lower((br, bi), nb=nb_chol, block_kernel=cfg.mosaic_kernels)
        # PHASE 2: C = L^{-1} A L^{-H} = L^{-1} (L^{-1} A^H)^H
        x = _solve_l(l, (ar, ai), nb=nb_chol)
        y = _solve_l(l, pH(x), nb=nb_chol)
        cr, ci = pH(y)
        cr = (cr + cr.T) / 2
        ci = (ci - ci.T) / 2

        # PHASE 3: tridiagonalize -> real D&C -> back-transform
        nbt = cfg.nb_tridiag
        npad = -(-n // nbt) * nbt
        cr_p, ci_p = _pad_planar(cr, ci, npad)
        if cfg.tridiag_mode == "two" and npad % cfg.band == 0 and npad >= 3 * cfg.band:
            w, (yr, yi) = _two_stage_planar(cr_p, ci_p, il, iu, cfg)
        else:
            (pr, pi), d, e, (taur, taui) = hetrd_planar(
                cr_p, ci_p, nb=nbt, bucket=128, use_pallas=cfg.use_pallas
            )
            w_all, q_tri = _tri_eigh(d, e, cfg)
            w = w_all[il - 1 : iu]
            zr0 = q_tri[:, il - 1 : iu]
            yr, yi = unmtr_planar(pr, pi, taur, taui, zr0, torch.zeros_like(zr0),
                                  nb=cfg.nb_back)
        yr, yi = yr[:n], yi[:n]

        # PHASE 4: x = L^{-H} y  (L^H is upper triangular)
        zr, zi = ptrsm_left_upper(pH(l), (yr, yi), nb=nb_chol, solve_lower=_solve_l)
        return PlanarResult(w=w, zr=zr, zi=zi, info=info)


def zhegvdx_planar_host(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG,
                        device="cuda"):
    """Convenience wrapper for complex host arrays: splits them into
    planar tensors on ``device`` (the card by default) and solves."""
    a = np.asarray(a)
    dtype = torch.float32 if a.dtype == np.complex64 else torch.float64
    return zhegvdx_planar(
        *planar_from_numpy(a, b, device=device, dtype=dtype), il=il, iu=iu, cfg=cfg
    )
