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
route) in ``to_standard`` and phase 4 in ``back_solve``. A solve whose n
is not its padded size (``_padded_size``) pads the pencil
(``_pad_pencil``): the padding and the raising of the padded diagonal
before the tridiagonal eigensolve (``_lift_pad``) are the range
``pad_pencil``, and the counter ``pad.rows`` adds the rows padded, once a
solve (a batch shares them).
"""

from __future__ import annotations

import math
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
from eigensolver_gpu_torch.utils.tracing import count, trace_range


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


def _padded_size(n, nbt):
    """The size the pipeline runs at: a multiple of ``nb_tridiag``, and
    past 128 of 128 too, the Cholesky's and the solves' block."""
    size = -(-n // nbt) * nbt
    if size > 128:
        step = math.lcm(128, nbt)
        size = -(-n // step) * step
    return size


def _pad_pencil(xr, xi, size, diag):
    """The planar matrix in the top left of size x size planes, ``diag`` on
    the new diagonal entries and 0 elsewhere: identity for B and zeros for A,
    so the Cholesky factor of the padded B is exactly block diagonal (L, I)
    and the padded rows and columns of C = L^{-1} A L^{-H} are exactly 0.
    The reductions keep that block exactly apart (each reflector is 0 on
    it), so the tridiagonal matrix is block diagonal too, with a zero
    trailing block that ``_lift_pad`` raises above the spectrum."""
    n = xr.shape[-1]
    out_r = xr.new_zeros(xr.shape[:-2] + (size, size))
    out_i = torch.zeros_like(out_r)
    out_r[..., :n, :n] = xr
    out_i[..., :n, :n] = xi
    if diag:
        torch.diagonal(out_r, dim1=-2, dim2=-1)[..., n:] = diag
    return out_r, out_i


def _lift_pad(d, e, n):
    """(d, e) of a padded pencil's tridiagonal matrix with its rows past n
    decoupled (e from row n - 1 on set to 0) and their diagonal set just
    above the spectrum of the first n rows, so they sort last. The bound is
    the Gershgorin bound of those n rows, one an item, or 1 where it is 0;
    the pad values lie within 1/16 + k/1024 above it. stedc scales by its
    largest entry and separates close poles by a multiple of that scale: a
    pad far above the spectrum (a bound taken from C before the reduction,
    its max row sum, can lie sqrt(n) times above it; twice the Gershgorin
    bound left 1 item in 100 at b_orth 1e-11 to 1e-10 after refinement at
    n = 1478 on an H100) widens that separation against the spectrum. JAX pads C at
    its max row sum + 1.0, which sets stedc's scale near 2 for a C of small
    norm; the port departs from JAX there."""
    k = d.shape[-1] - n
    rows = d[..., :n].abs()
    off = e[..., : n - 1].abs()
    rows[..., 1:] += off
    rows[..., :-1] += off
    bound = torch.amax(rows, dim=-1)
    bound = torch.where(bound == 0, torch.ones_like(bound), bound)
    padvals = bound[..., None] * (
        1.0625 + torch.arange(k, dtype=d.dtype, device=d.device) * (1.0 / 1024.0)
    )
    return (torch.cat([d[..., :n], padvals], -1),
            torch.cat([e[..., : n - 1], e.new_zeros(e.shape[:-1] + (k,))], -1))


def _tri_eigh(d, e, cfg, n_pencil=None):
    """Tridiagonal eigensolve per cfg.stedc_backend: 'dc' = on-device
    divide and conquer, 'xla' = dense eigh of the tridiagonal. ``n_pencil``:
    the size of a pencil that ``_pad_pencil`` padded, whose padded
    diagonal is raised first (``_lift_pad``)."""
    if n_pencil is not None:
        with trace_range("pad_pencil"):
            d, e = _lift_pad(d, e, n_pencil)
    if cfg.stedc_backend == "xla":
        return eigh_or_nan(
            torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
        )
    return stedc(d, e, leaf=cfg.stedc_leaf)


def _two_stage_planar(cr_p, ci_p, il, iu, cfg, n_pencil=None):
    """PHASE 3 by the two-stage reduction: returns (w, (yr, yi)) with the
    eigenvector chain y = Q1 Q2 D z_tri (D from phase_normalize). Leading
    axes of the planes are a batch of problems, reduced together: one panel
    call a panel step, one chase and one replay for the whole batch.
    ``n_pencil`` as in ``_tri_eigh``."""
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
    w_all, q_tri = _tri_eigh(d, e_abs, cfg, n_pencil)
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
    (``zhegvdx_planar_batched`` is the batched entry point).

    Any n >= 1 is solved. An n that is not a multiple of ``nb_tridiag``,
    or past 128 not a multiple of 128, is padded to the next size that is
    (``_padded_size``; ``_pad_pencil``: identity in B, zeros in A), the
    padded block of the tridiagonal matrix is raised above the spectrum
    before the tridiagonal eigensolve (``_lift_pad``), so no padded pair
    enters il..iu, and the eigenvectors are cut back to n. JAX raises past
    128 (its blocked Cholesky needs ``n % 128 == 0``) and pads C alone
    below it: the port departs from JAX there."""
    n = ar.shape[-1]
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"require 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
    nbt = cfg.nb_tridiag
    npad = _padded_size(n, nbt)
    nb_chol = min(128, npad)

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
        and npad % 128 == 0
        and (npad // 128) & (npad // 128 - 1) == 0
    )
    if ar.dtype == torch.float32 and cfg.planar_solve_mode != "subst":
        subst = ptrsm_left_lower_inv
    else:
        subst = ptrsm_left_lower

    with trace_range("zhegvdx_planar"):
        if npad != n:
            with trace_range("pad_pencil"):
                count("pad.rows", npad - n)
                ar, ai = _pad_pencil(ar, ai, npad, 0.0)
                br, bi = _pad_pencil(br, bi, npad, 1.0)
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
        n_pencil = n if npad != n else None
        if _two_stage_engaged(npad, cfg):
            w, (yr, yi) = _two_stage_planar(cr, ci, il, iu, cfg, n_pencil)
        else:
            (pr, pi), d, e, (taur, taui) = hetrd_planar(
                cr, ci, nb=nbt, bucket=128, use_pallas=cfg.use_pallas
            )
            w_all, q_tri = _tri_eigh(d, e, cfg, n_pencil)
            w = w_all[..., il - 1 : iu]
            zr0 = q_tri[..., il - 1 : iu]
            yr, yi = unmtr_planar(pr, pi, taur, taui, zr0, torch.zeros_like(zr0),
                                  nb=cfg.nb_back)

        # PHASE 4: x = L^{-H} y  (L^H is upper triangular)
        with trace_range("back_solve"):
            zr, zi = solve_u((yr, yi))
        if npad != n:
            # L^H is block diagonal: the first n rows of x are the pencil's
            zr, zi = zr[..., :n, :], zi[..., :n, :]
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
