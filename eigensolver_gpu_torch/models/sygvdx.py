"""Generalized eigensolver drivers: ``A x = lambda B x`` (ITYPE=1,
JOBZ='V', RANGE='I', UPLO='U'; twin of
eigensolver_gpu_tpu/models/sygvdx.py).

Mirrors the reference's public API -- ``dsygvdx_gpu``
(dsygvdx_gpu.F90:71) and ``zhegvdx_gpu`` (zhegvdx_gpu.F90:75) -- with the
same 5-phase pipeline (zhegvdx_gpu.F90:131-180):

  1. Cholesky  B = U^H U                      (ops/cholesky.py)
  2. reduce to standard form C = U^{-H} A U^{-1}   (ops/sygst.py)
  3. standard eigensolve of C, select il..iu  (models/syevdx.py)
  4. back-substitute x = U^{-1} y             (ops/trsm.py)
  5. results stay on the device

With ``SolverConfig(compute_dtype='float32')`` and fp64 inputs the whole
pipeline runs in fp32 and the selected block is refined in fp64 against
(A, B) (ops/refine.refine_gevp). ``info`` is returned as an int32 0-d
tensor on the device (0 ok, > 0: B not positive definite), never raised.

``sygvdx`` and ``syevdx`` take tensors and run on the tensors' device;
``dsygvdx`` and ``zhegvdx`` also take numpy arrays, which go to the
``device`` keyword (the card by default). Nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigensolver_gpu_torch.models.syevdx import syevdx
from eigensolver_gpu_torch.ops.cholesky import cholesky_upper
from eigensolver_gpu_torch.ops.refine import refine_gevp
from eigensolver_gpu_torch.ops.sygst import sygst
from eigensolver_gpu_torch.ops.trsm import trinv_upper_full, trsm_phase4
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


class SygvdxResult(NamedTuple):
    w: torch.Tensor  # (m,) real eigenvalues, ascending, m = iu - il + 1
    z: torch.Tensor  # (n, m) B-orthonormal eigenvectors
    info: torch.Tensor  # int32 0-d: 0 ok, >0 B not positive definite


def _from_upper(a):
    """Rebuild the symmetric/Hermitian matrix from its upper triangle --
    the reference's UPLO='U' contract (zhegvdx_gpu.F90:58: only A's upper
    triangle is read; the lower may hold anything)."""
    up = torch.triu(a, 1)
    return up + up.mH + torch.diag(torch.diagonal(a).real.to(a.dtype))


def _lowprec(dtype):
    return dtype in (torch.float32, torch.complex64)


@highest_precision
def sygvdx(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Solve A x = lambda B x for eigenpairs il..iu (1-based, ascending).

    Only the upper triangles of A and B are read (LAPACK UPLO='U'
    semantics, matching the reference's contract)."""
    n = a.shape[0]
    if a.shape != (n, n) or b.shape != (n, n):
        raise ValueError(
            f"A and B must be square and equal shape, got {tuple(a.shape)}, {tuple(b.shape)}"
        )
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"need 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
    a = _from_upper(a)
    b = _from_upper(b)

    if cfg.compute_dtype == "float32" and a.dtype == torch.float64:
        # full-fp32 generalized pipeline + fp64 generalized Ogita-Aishima
        # refinement -- the real twin of the planar mixed driver
        inner = SolverConfig(
            nb_sygst=cfg.nb_sygst, nb_tridiag=cfg.nb_tridiag,
            nb_back=cfg.nb_back, stedc_leaf=cfg.stedc_leaf,
            stedc_backend=cfg.stedc_backend,
            sygst_mode=cfg.sygst_mode, use_pallas=cfg.use_pallas,
            tridiag_mode=cfg.tridiag_mode, band=cfg.band,
            two_stage_min_n=cfg.two_stage_min_n, replay_g=cfg.replay_g,
            mosaic_kernels=cfg.mosaic_kernels,
        )
        w32, z32, info = sygvdx(a.float(), b.float(), il=1, iu=n, cfg=inner)
        # refine only the il..iu block + cluster-guard margin against the
        # full fp32 basis; per-sweep gemms shrink from n^3 to n^2*ms
        sel0 = max(0, il - 1 - cfg.refine_margin)
        sel1 = min(n, iu + cfg.refine_margin)
        w, z = refine_gevp(
            a, b, z32.to(a.dtype), sweeps=cfg.refine_iters,
            chunk=2048 if n >= 8192 else None,
            sel=(sel0, sel1 - sel0), w0=w32.to(a.dtype),
            extra_max=cfg.refine_extra_max,
        )
        order = torch.argsort(w, stable=True)
        w = w[order]
        z = z[:, order]
        lo = il - 1 - sel0
        return SygvdxResult(
            w=w[lo : lo + (iu - il + 1)], z=z[:, lo : lo + (iu - il + 1)], info=info
        )

    sygst_mode = cfg.sygst_mode
    if sygst_mode == "trinv":
        # full block-doubled inv(U) reused for phases 2 AND 4: log-depth
        # gemms, no sequential solve steps. Forward error ~eps * kappa(U)
        # -- fp32 pipelines only (the fp64 refinement absorbs it); falls
        # back when n is not 512 * 2^k or the dtype carries the accuracy
        # contract
        trinv_ok = (
            _lowprec(a.dtype) and n % 512 == 0 and (n // 512) & (n // 512 - 1) == 0
        )
        if trinv_ok:
            with trace_range("sygvdx"):
                u, info = cholesky_upper(b)
                inv = trinv_upper_full(u, base=512)
                c = inv.mH @ (a @ inv)
                c = (c + c.mH) / 2
                w, y = syevdx(c, il=il, iu=iu, cfg=cfg)
                return SygvdxResult(w=w, z=inv @ y, info=info)
        sygst_mode = "full"
    if sygst_mode == "full":
        # 'inv' needs the batched block inversion: nb must divide n and
        # be 16 * 2^j (ops/trsm._trinv_lower_batched); an incompatible nb
        # stays on 'full'/'blocked' instead of raising
        nbs = cfg.nb_sygst
        nb_ok = n % nbs == 0 and nbs % 16 == 0 and (nbs // 16) & (nbs // 16 - 1) == 0
        if _lowprec(a.dtype) and nb_ok and n >= 1024:
            sygst_mode = "inv"
        elif n >= 8192:
            sygst_mode = "blocked"

    with trace_range("sygvdx"):
        u, info = cholesky_upper(b)  # PHASE 1 (zhegvdx_gpu.F90:135)
        c = sygst(a, u, mode=sygst_mode, nb=cfg.nb_sygst)  # PHASE 2 (:158)
        w, y = syevdx(c, il=il, iu=iu, cfg=cfg)  # PHASE 3 (:163)
        # PHASE 4: x = U^{-1} y; fp32 pipelines use the inverse-diagonal
        # blocked solve, fp64 keeps exact substitution
        return SygvdxResult(w=w, z=trsm_phase4(u, y), info=info)


def _as_tensor(x, device):
    """Tensors stay where they are; anything else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x).to(device)


def dsygvdx(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG, device="cuda"):
    """Real driver (dsygvdx_gpu.F90:71). A symmetric, B SPD, float32/64.
    Tensors are solved on their device; numpy arrays go to ``device``."""
    a = _as_tensor(a, device)
    b = _as_tensor(b, device)
    if not a.is_floating_point():
        raise TypeError(f"dsygvdx expects real input, got {a.dtype}")
    return sygvdx(a, b, il=il, iu=iu, cfg=cfg)


def zhegvdx(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG, device="cuda"):
    """Complex driver (zhegvdx_gpu.F90:75). A Hermitian, B HPD. Tensors
    are solved on their device; numpy arrays go to ``device``."""
    a = _as_tensor(a, device)
    b = _as_tensor(b, device)
    if not a.is_complex():
        raise TypeError(f"zhegvdx expects complex input, got {a.dtype}")
    return sygvdx(a, b, il=il, iu=iu, cfg=cfg)
