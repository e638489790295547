"""Batched and sharded generalized solves (twin of
eigensolver_gpu_tpu/parallel/sharded.py).

``sygvdx_batched`` is the JAX package's ``vmap`` of ``sygvdx`` over a
leading batch axis (BASELINE.md config 4, Quantum ESPRESSO k-points),
for real and complex dtypes, on one card. The batch axis runs through
every stage of the pipeline, so each column step of the reduction serves
the whole batch (with ``use_pallas=True``, one launch of K4 a column for
the batch); where the two-stage reduction engages, each sbrd panel, the
chase and the Q2 replay are one launch of K5, K7 and K9 for the batch.

The sharded solves run over a ('dp', 'tp') mesh of torch.distributed
ranks (``parallel/mesh.make_mesh``). As with JAX's host arrays, every
rank passes the whole matrices and gets the whole result; inside, each
rank does its share and ``parallel/comm.py``'s collectives assemble it
(JAX lets the SPMD partitioner place the work and its collectives):

  * tensor parallel ('tp'), ``sygvdx_sharded`` (BASELINE.md config 5):
    the dominant stages split over the 'tp' ranks -- the full-inverse
    reduction to standard form and phase 4 by rows, the tridiagonal
    reduction by rows (ops/sytrd.py, ops/sbrd.py), stedc's top merges,
    the back-transform by columns of Z and the refinement by rows
    (models/syevdx.py, ops/refine.py). The chase (K7) runs whole on every
    rank, as JAX keeps it replicated;
  * data parallel, ``sygvdx_batched_sharded`` and
    ``zhegvdx_planar_batched_sharded``: each rank solves a contiguous
    share of the batch (in JAX's order over ('dp', 'tp')) with the
    batched driver, no collective inside a solve, then one all_gather a
    mesh dimension of each output.

JAX turns its Pallas kernels off in the data-parallel entries
(``_no_mosaic``) and in the tp panel and replay because a Pallas call
cannot be SPMD-partitioned. Here each rank launches the kernels on its own
tensors, so they stay on; ``_no_mosaic`` is kept for parity of the
configuration and not applied (ROADMAP.md C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# sygvdx is not called here (the batched entry is one batched solve); it stays in this
# module's namespace, as in the JAX package's twin
from eigensolver_gpu_torch.models.sygvdx import (  # noqa: F401
    SygvdxResult,
    _from_upper,
    _sygvdx,
    sygvdx,
)
from eigensolver_gpu_torch.models.syevdx import sort_pairs, syevdx
from eigensolver_gpu_torch.ops.cholesky import cholesky_upper
from eigensolver_gpu_torch.ops.refine import refine_gevp
from eigensolver_gpu_torch.ops.sygst import sygst_blocked, sygst_full
from eigensolver_gpu_torch.ops.trsm import trinv_upper_full, trsm_phase4
from eigensolver_gpu_torch.parallel import comm
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


@highest_precision
def sygvdx_batched(a, b, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Solve A_k x = lambda B_k x for a batch of pairs: a, b (batch, n, n).

    Returns SygvdxResult with a leading batch axis: w (batch, m), z
    (batch, n, m), info (batch,) int32. Each item is the solve of
    ``sygvdx`` on it; a B_k that is not positive definite sets its own
    ``info`` and leaves the other items as they are."""
    if a.dim() != 3 or b.shape != a.shape or a.shape[-1] != a.shape[-2]:
        raise ValueError(
            f"sygvdx_batched takes (batch, n, n) pairs of one shape, got "
            f"{tuple(a.shape)}, {tuple(b.shape)}"
        )
    return _sygvdx(a, b, il, iu, cfg)


def _no_mosaic(cfg: SolverConfig) -> SolverConfig:
    """Config with the kernels forced off (JAX applies it to its sharded
    batch axes; kept for parity, not applied here: module docstring)."""
    if not cfg.mosaic_kernels:
        return cfg
    return dataclasses.replace(cfg, mosaic_kernels=False)


def _on_mesh_device(mesh, *xs):
    """Tensors stay where they are; numpy arrays go to the rank's device."""
    dev = comm.device(mesh)
    return [x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=dev)
            for x in xs]


@highest_precision
def _sharded_step(a, b, mesh, il, iu, cfg):
    return _sharded_step_body(a, b, mesh, il, iu, cfg)


def _sharded_step_body(a, b, mesh, il, iu, cfg):
    n = a.shape[0]
    # UPLO='U' contract, the same normalization as the unsharded driver
    a = _from_upper(a)
    b = _from_upper(b)

    if cfg.compute_dtype == "float32" and a.dtype == torch.float64:
        # the whole fp32 generalized pipeline sharded, then the sharded
        # selected-range fp64 refinement (the mixed driver's scheme). The
        # full-inverse phases 2 and 4 are an fp32-inner economy whose
        # eps32 * kappa(U) forward error the refinement absorbs: the inner
        # solve takes them where n qualifies, unless the caller pinned
        # 'blocked'
        inv_ok = n % 512 == 0 and (n // 512) & (n // 512 - 1) == 0
        inner_sygst = "trinv" if inv_ok and cfg.sygst_mode != "blocked" else cfg.sygst_mode
        inner = SolverConfig(
            nb_sygst=cfg.nb_sygst, nb_tridiag=cfg.nb_tridiag,
            nb_back=cfg.nb_back, stedc_leaf=cfg.stedc_leaf,
            stedc_backend=cfg.stedc_backend,
            sygst_mode=inner_sygst, use_pallas=cfg.use_pallas,
            tridiag_mode=cfg.tridiag_mode, band=cfg.band,
            two_stage_min_n=cfg.two_stage_min_n, replay_g=cfg.replay_g,
            mosaic_kernels=cfg.mosaic_kernels,
        )
        r32 = _sharded_step(a.float(), b.float(), mesh, 1, n, inner)
        sel0 = max(0, il - 1 - cfg.refine_margin)
        sel1 = min(n, iu + cfg.refine_margin)
        w, z = refine_gevp(
            a, b, r32.z.to(a.dtype), sweeps=cfg.refine_iters,
            chunk=2048 if n >= 8192 else None,
            sel=(sel0, sel1 - sel0), w0=r32.w.to(a.dtype),
            extra_max=cfg.refine_extra_max, mesh=mesh,
        )
        w, z = sort_pairs(w, z)
        lo = il - 1 - sel0
        return SygvdxResult(w=w[lo : lo + (iu - il + 1)], z=z[:, lo : lo + (iu - il + 1)],
                            info=r32.info)

    with trace_range("sygvdx_sharded"):
        return _sharded_phases(a, b, mesh, il, iu, cfg)


def _sharded_phases(a, b, mesh, il, iu, cfg):
    """Phases 1 to 4 of one sharded solve in the dtype of a and b."""
    n = a.shape[0]
    u, info = cholesky_upper(b)
    # phases 2 and 4 by the full inverse (an explicit opt-in: the mixed
    # path sets it on its fp32 inner solve): inv(U) once by block doubling
    # on every rank, then C = inv^H (A inv) and Z = inv Y as gemms over the
    # ranks' rows
    lowprec = a.dtype in (torch.float32, torch.complex64)
    inv_ok = n % 512 == 0 and (n // 512) & (n // 512 - 1) == 0
    split = comm.row_range(n, mesh) is not None
    rows = lambda m: comm.row_block(m, mesh)
    if lowprec and inv_ok and cfg.sygst_mode == "trinv":
        inv = trinv_upper_full(u, base=512)
        if not split:
            c = inv.mH @ (a @ inv)
        else:  # the rank's partial sum over its rows, summed and scattered by rows
            c = comm.all_gather(comm.reduce_scatter(rows(inv).mH @ (rows(a) @ inv), mesh,
                                                    what="sygst"), mesh, what="sygst")
        c = (c + c.mH) / 2
    else:
        inv = None
        if n >= 8192 or cfg.sygst_mode == "blocked":
            c = sygst_blocked(a, u, nb=cfg.nb_sygst)
        else:
            c = sygst_full(a, u)
    # the standard solve with its dominant stages split over 'tp'
    w, y = syevdx(c, il=il, iu=iu, cfg=cfg, mesh=mesh)
    if inv is None:
        z = trsm_phase4(u, y)
    elif not split:
        z = inv @ y
    else:  # phase 4: the rank's rows of inv times Y
        z = comm.all_gather(rows(inv) @ y, mesh, what="phase4")
    return SygvdxResult(w=w, z=z, info=info)


def sygvdx_sharded(a, b, mesh, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Tensor-parallel generalized solve: the dominant stages split over
    the rows of the mesh's 'tp' ranks (module docstring). Every rank
    passes the whole (n, n) A and B (tensors on its device, or numpy
    arrays, which go there) and gets the whole SygvdxResult."""
    a, b = _on_mesh_device(mesh, a, b)
    n = a.shape[0]
    if a.shape != (n, n) or b.shape != (n, n):
        raise ValueError(
            f"A and B must be square and equal shape, got {tuple(a.shape)}, {tuple(b.shape)}"
        )
    if iu is None:
        iu = n
    return _sharded_step(a, b, mesh, il, iu, cfg)


def _share(batch, mesh):
    """This rank's contiguous share of the batch, in JAX's order of the
    devices over ('dp', 'tp')."""
    ndev = mesh.size()
    if batch % ndev != 0:
        raise ValueError(f"batch {batch} not divisible by {ndev} devices")
    k = comm.rank(mesh, "dp") * comm.size(mesh, "tp") + comm.rank(mesh, "tp")
    per = batch // ndev
    return slice(k * per, (k + 1) * per)


def _gather_batch(result, mesh):
    """Every rank's share of each output, in the batch's order."""
    gather = lambda x: comm.all_gather(comm.all_gather(x, mesh, "tp", axis=0, what="dp"),
                                       mesh, "dp", axis=0, what="dp")
    return type(result)(*(gather(x) for x in result))


def sygvdx_batched_sharded(a, b, mesh, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG):
    """Batched solves with the batch axis split over 'dp' x 'tp': each rank
    solves batch / ranks whole problems with ``sygvdx_batched`` (kernels
    on), then the results are gathered. Every rank passes the whole
    (batch, n, n) A and B and gets the whole result."""
    share = _share(a.shape[0], mesh)
    a, b = _on_mesh_device(mesh, a[share], b[share])
    return _gather_batch(sygvdx_batched(a, b, il=il, iu=iu, cfg=cfg), mesh)


def zhegvdx_planar_batched_sharded(
    ar, ai, br, bi, mesh, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG, chunk=None,
):
    """Batched planar complex solves with the batch axis split over the
    mesh: the multi-chip form of BASELINE config 4 (QE k-point batches
    are Hermitian). Each rank solves batch / ranks whole planar problems
    with ``zhegvdx_planar_batched`` (kernels on), no collective inside a
    solve, then the results are gathered.

    ``chunk`` chunks the GLOBAL batch, as in JAX: each rank solves its
    share ``chunk / ranks`` items at a time, so ``chunk`` must divide the
    batch and the rank count must divide ``chunk``."""
    from eigensolver_gpu_torch.models.zhegvdx_planar import zhegvdx_planar_batched

    batch = ar.shape[0]
    share = _share(batch, mesh)
    local_chunk = None
    if chunk is not None:
        ndev = mesh.size()
        if batch % chunk != 0:
            raise ValueError(f"batch {batch} not divisible by chunk {chunk}")
        if chunk % ndev != 0:
            raise ValueError(f"chunk {chunk} not divisible by {ndev} devices")
        local_chunk = chunk // ndev
    planes = _on_mesh_device(mesh, *(x[share] for x in (ar, ai, br, bi)))
    return _gather_batch(
        zhegvdx_planar_batched(*planes, il=il, iu=iu, cfg=cfg, chunk=local_chunk), mesh)
