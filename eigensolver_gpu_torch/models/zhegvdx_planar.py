"""Planar complex generalized eigensolver (twin of
eigensolver_gpu_tpu/models/zhegvdx_planar.py): zhegvdx,
A x = lambda B x with LAPACK ITYPE=1, JOBZ='V', RANGE='I', UPLO='U', on
(re, im) real pairs.

The reference's 5-phase pipeline (zhegvdx_gpu.F90:131-180):

  1. B = L L^H               planar blocked Cholesky (ops/planar.py,
                             diagonal blocks by kernel K1 in fp32)
  2. C = L^{-1} A L^{-H}     two planar triangular solves
  3. hetrd_planar -> real (d, e) -> stedc -> select il..iu
     -> unmtr_planar back-transform   (kernel K2 a panel with
                                       use_pallas=True);
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

``zhegvdx_planar_batched`` solves a batch of problems (leading axis) with
the batch axis through every stage of the one-stage pipeline (with
``use_pallas=True``, K2 once a panel for the whole batch) and, with
``tridiag_mode='two'``, of the two-stage pipeline (K6 once a panel, K8 and
K10 once a solve, for the whole batch).

The triangular solves of phases 2 and 4 follow ``cfg.planar_solve_mode``
(default ``'blockinv'``), by the JAX rule: ``'trinv'`` forms the full
inv(L) once (``ops/planar.ptrinv_lower``) and turns the three solves into
planar gemms, phase 2 as ``pmatmul(inv(L), .)`` and phase 4 as
``pmatmul(inv(L)^H, .)``; its gate is fp32 input with n / 128 a power of
two (n = 4096 qualifies). Where the gate fails, ``'trinv'`` and
``'blockinv'`` take the block-inverted substitution
(``ptrsm_left_lower_inv``) in fp32 and ``'subst'`` and every fp64 solve the
exact substitution (``ptrsm_left_lower``). The mixed driver passes the mode
to its fp32 inner solve, one-stage or two-stage, batched or not.

Under ``utils/tracing.py`` the solve is the range ``zhegvdx_planar``, with
phase 1 in ``potrf``, phase 2 (the inverse of L too, on the ``'trinv'``
route) in ``to_standard`` and phase 4 in ``back_solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eigensolver_gpu_torch.models.syevdx import sort_pairs
from eigensolver_gpu_torch.ops.planar import (
    pcholesky_lower,
    pH,
    pmatmul,
    ptrinv_lower,
    ptrsm_left_lower,
    ptrsm_left_lower_inv,
    ptrsm_left_upper,
)
from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
from eigensolver_gpu_torch.ops.stedc import eigh_or_nan, stedc
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
    return upr + upr.mT + torch.diag_embed(torch.diagonal(xr, dim1=-2, dim2=-1)), upi - upi.mT


def _pad_planar(ar, ai, npad):
    """Pad to npad with decoupled diagonal entries above the spectrum
    (tightly spaced: wide ramps inflate stedc's fp32 deflation
    thresholds). The bound is the max row sum, one an item, or 1 where
    that is 0: JAX's ``+ 1.0`` is left out, as in
    models/syevdx._pad_decoupled, whose docstring says why (a departure
    from JAX on padded inputs only)."""
    n = ar.shape[-1]
    if npad == n:
        return ar, ai
    # one bound an item
    bound = torch.amax(torch.sum(torch.sqrt(ar * ar + ai * ai), dim=-1), dim=-1)
    bound = torch.where(bound == 0, torch.ones_like(bound), bound)
    k = npad - n
    padvals = bound[..., None] * (
        2.0 + torch.arange(k, dtype=ar.dtype, device=ar.device) * (1.0 / 256.0)
    )
    out_r = torch.zeros(ar.shape[:-2] + (npad, npad), dtype=ar.dtype, device=ar.device)
    out_i = torch.zeros_like(out_r)
    out_r[..., :n, :n] = ar
    out_i[..., :n, :n] = ai
    idx = torch.arange(n, npad, device=ar.device)
    out_r[..., idx, idx] = padvals
    return out_r, out_i


def _tri_eigh(d, e, cfg):
    """Tridiagonal eigensolve per cfg.stedc_backend: 'dc' = on-device
    divide and conquer, 'xla' = dense eigh of the tridiagonal."""
    if cfg.stedc_backend == "xla":
        return eigh_or_nan(
            torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
        )
    return stedc(d, e, leaf=cfg.stedc_leaf)


def _two_stage_planar(cr_p, ci_p, il, iu, cfg):
    """PHASE 3 by the two-stage reduction: returns (w, (yr, yi)) with the
    eigenvector chain y = Q1 Q2 D z_tri (D from phase_normalize). Leading
    axes of the planes are a batch of problems, reduced together: one panel
    call a panel step, one chase and one replay for the whole batch."""
    from eigensolver_gpu_torch.ops.sb2st import dense_to_band
    from eigensolver_gpu_torch.ops.sb2st_planar import (
        apply_q2_planar,
        bulge_chase_planar,
        phase_normalize,
    )
    from eigensolver_gpu_torch.ops.sbrd_planar import apply_q1_planar, psbrd

    npad, band = cr_p.shape[-1], cfg.band
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
    z0 = q_tri[..., il - 1 : iu]
    y0 = (z0 * p_r[..., :, None], z0 * p_i[..., :, None])
    # replay group size: the JAX default, 3*band in fp32 (l_win = 127 at
    # band 32) and band in fp64
    g = cfg.replay_g or (3 * band if cr_p.dtype == torch.float32 else band)
    if cfg.mosaic_kernels:
        from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel

        y = apply_q2_planar_kernel(vt, taut, y0, npad, band, g=g)
    else:
        y = apply_q2_planar(vt, taut, y0, npad, band, g=g)
    return w_all[..., il - 1 : iu], apply_q1_planar(vs, ts, y)


def _two_stage_engaged(npad, cfg):
    """The planar two-stage gate: ``tridiag_mode='two'`` and a padded size
    that is a multiple of ``band`` and at least ``3 * band``."""
    return cfg.tridiag_mode == "two" and npad % cfg.band == 0 and npad >= 3 * cfg.band


@highest_precision
def zhegvdx_planar(ar, ai, br, bi, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Planar A x = lambda B x, eigenpairs il..iu (1-based).

    Returns PlanarResult(w, zr, zi, info) with info the cuSOLVER devInfo
    of the Cholesky of B (0 on success, else the 1-based column of the
    first non-positive pivot), as an int32 0-d tensor on the device.

    Leading axes of the four planes are a batch of problems, solved
    together by the one-stage or the two-stage pipeline
    (``zhegvdx_planar_batched`` is the batched entry point)."""
    n = ar.shape[-1]
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"require 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
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
        w, zr, zi = sort_pairs(w, zr, zi)
        lo = il - 1 - sel0
        hi = lo + (iu - il + 1)
        return PlanarResult(w=w[..., lo:hi], zr=zr[..., lo:hi], zi=zi[..., lo:hi], info=info)

    # fp32: diagonal-block-inverted solves (n/nb sequential steps; the
    # fp64 refinement absorbs the eps32 * kappa forward error); fp64 or
    # 'subst': pure substitution; 'trinv' where its gate holds: one full
    # inv(L) and planar gemms
    trinv_ok = (
        cfg.planar_solve_mode == "trinv"
        and ar.dtype == torch.float32
        and n % 128 == 0
        and (n // 128) & (n // 128 - 1) == 0
    )
    if ar.dtype == torch.float32 and cfg.planar_solve_mode != "subst":
        subst = ptrsm_left_lower_inv
    else:
        subst = ptrsm_left_lower

    with trace_range("zhegvdx_planar"):
        with trace_range("potrf"):
            l, info = pcholesky_lower((br, bi), nb=nb_chol, block_kernel=cfg.mosaic_kernels)
        with trace_range("to_standard"):
            if trinv_ok:
                linv = ptrinv_lower(l)
                solve_l = lambda rhs: pmatmul(linv, rhs)
                # phase 4 solves L^H x = y, so x = inv(L)^H y
                solve_u = lambda rhs: pmatmul(pH(linv), rhs)
            else:
                solve_l = lambda rhs: subst(l, rhs, nb=nb_chol)
                solve_u = lambda rhs: ptrsm_left_upper(pH(l), rhs, nb=nb_chol,
                                                       solve_lower=subst)
            # PHASE 2: C = L^{-1} A L^{-H} = L^{-1} (L^{-1} A^H)^H
            x = solve_l((ar, ai))
            y = solve_l(pH(x))
            cr, ci = pH(y)
            cr = (cr + cr.mT) / 2
            ci = (ci - ci.mT) / 2

        # PHASE 3: tridiagonalize -> real D&C -> back-transform
        nbt = cfg.nb_tridiag
        npad = -(-n // nbt) * nbt
        cr_p, ci_p = _pad_planar(cr, ci, npad)
        if _two_stage_engaged(npad, cfg):
            w, (yr, yi) = _two_stage_planar(cr_p, ci_p, il, iu, cfg)
        else:
            (pr, pi), d, e, (taur, taui) = hetrd_planar(
                cr_p, ci_p, nb=nbt, bucket=128, use_pallas=cfg.use_pallas
            )
            w_all, q_tri = _tri_eigh(d, e, cfg)
            w = w_all[..., il - 1 : iu]
            zr0 = q_tri[..., il - 1 : iu]
            yr, yi = unmtr_planar(pr, pi, taur, taui, zr0, torch.zeros_like(zr0),
                                  nb=cfg.nb_back)
        yr, yi = yr[..., :n, :], yi[..., :n, :]

        # PHASE 4: x = L^{-H} y  (L^H is upper triangular)
        with trace_range("back_solve"):
            zr, zi = solve_u((yr, yi))
        return PlanarResult(w=w, zr=zr, zi=zi, info=info)


def _stack_results(parts, kind):
    """One result of the whole batch from the results of its parts."""
    return kind(*(torch.cat([getattr(p, f) for p in parts], 0) for f in kind._fields))


def _chunks(batch, chunk):
    """Slices of the batch solved one after the other (JAX's lax.map over
    vmap): the whole batch when ``chunk`` is None or covers it."""
    if chunk is None or chunk >= batch:
        return [slice(0, batch)]
    if batch % chunk != 0:
        raise ValueError(f"batch {batch} not divisible by chunk {chunk}")
    return [slice(c, c + chunk) for c in range(0, batch, chunk)]


def zhegvdx_planar_batched(
    ar, ai, br, bi, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG, chunk=None
):
    """A batch of planar problems (Quantum ESPRESSO k-point batches,
    BASELINE.md config 4): ``(batch, n, n)`` planes in, PlanarResult with
    a leading batch axis out: w (batch, k), zr and zi (batch, n, k), info
    (batch,) int32. Each item is the solve of ``zhegvdx_planar`` on it.

    The one-stage and the two-stage pipelines run the whole batch at once:
    a batch axis runs through every stage, so each block step of the
    Cholesky (one launch of kernel K1), each column step of the one-stage
    reduction (with ``use_pallas=True``, each panel: one launch of K2) and,
    with ``tridiag_mode='two'`` where it engages, each panel of psbrd (one
    launch of K6), the chase (one launch of K8) and the replay (one launch
    of K10) serve every problem.

    ``chunk``: solve the batch in sequential chunks of this size, to bound
    the peak memory; ``batch % chunk`` must be 0.
    """
    if ar.dim() != 3 or any(x.shape != ar.shape for x in (ai, br, bi)):
        raise ValueError(
            "zhegvdx_planar_batched takes four (batch, n, n) planes of one shape, got "
            f"{[tuple(x.shape) for x in (ar, ai, br, bi)]}"
        )
    parts = [zhegvdx_planar(ar[sl], ai[sl], br[sl], bi[sl], il=il, iu=iu, cfg=cfg)
             for sl in _chunks(ar.shape[0], chunk)]
    return parts[0] if len(parts) == 1 else _stack_results(parts, PlanarResult)


def zhegvdx_planar_host(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG,
                        device="cuda"):
    """Convenience wrapper for complex host arrays: splits them into
    planar tensors on ``device`` (the card by default) and solves."""
    a = np.asarray(a)
    dtype = torch.float32 if a.dtype == np.complex64 else torch.float64
    return zhegvdx_planar(
        *planar_from_numpy(a, b, device=device, dtype=dtype), il=il, iu=iu, cfg=cfg
    )
