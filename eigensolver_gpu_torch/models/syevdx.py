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
its arguments raises. Both routes take a leading batch axis
(``sygvdx_batched``): on the two-stage route each panel, the chase and the
Q2 replay are one kernel launch for the whole batch.

``mesh`` (a ('dp', 'tp') DeviceMesh, parallel/mesh.py; one problem) splits
the dominant stages over its 'tp' ranks, each stage taking and returning
whole tensors on every rank: the reduction's rows (ops/sytrd.py,
ops/sbrd.py), stedc's top merges, the back-transform's columns (each rank
replays Q2 with K9 and Q1, or unmtr, on its block of the columns of Z,
then one all_gather) and the refinement's rows. The chase (K7) runs whole
on every rank, as JAX keeps it replicated. JAX turns its QL panel and
replay kernels off under a mesh because a Pallas call cannot be
SPMD-partitioned; each rank here calls K5 and K9 on its own tensors, so
they stay on (ROADMAP.md C).
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.refine import refine_eigh
from eigensolver_gpu_torch.ops.stedc import eigh_or_nan, stedc
from eigensolver_gpu_torch.ops.sytrd import sytrd
from eigensolver_gpu_torch.ops.unmtr import unmtr
from eigensolver_gpu_torch.parallel import comm
from eigensolver_gpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _pad_decoupled(a, npad):
    """Embed A in an npad x npad matrix whose extra block is a decoupled
    diagonal strictly above A's spectrum (Gershgorin bound), so the padded
    eigenvalues sort after the real ones and index selection is unchanged.
    Tight spacing: the pad values feed stedc's scaling, and a wide ramp
    inflates its fp32 deflation thresholds.

    The bound is the max row sum, one an item, or 1 where that is 0. JAX
    adds 1.0 to it; for a matrix with a small norm that makes the pad
    values (near 2) set stedc's scale, and its fp32 deflation threshold
    then swallows A's whole spectrum (wrong eigenpairs with info = 0).
    The port departs from JAX here, on padded inputs only."""
    n = a.shape[-1]
    if npad == n:
        return a
    bound = torch.amax(torch.sum(a.abs(), dim=-1), dim=-1)  # one an item
    bound = torch.where(bound == 0, torch.ones_like(bound), bound)
    k = npad - n
    padvals = bound[..., None] * (
        2.0 + torch.arange(k, dtype=bound.dtype, device=a.device) * (1.0 / 256.0)
    )
    out = torch.zeros(a.shape[:-2] + (npad, npad), dtype=a.dtype, device=a.device)
    out[..., :n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[..., idx, idx] = padvals.to(a.dtype)
    return out


def _maybe_row_shard(x, mesh):
    """The mesh whose 'tp' ranks split the rows of x's stage, or None when
    there is no mesh or the rows do not split evenly (JAX's
    ``_maybe_row_shard`` constrains x to 'tp' row sharding, or does
    nothing then)."""
    return None if comm.row_range(x.shape[-2], mesh) is None else mesh


def _by_columns(fn, z, mesh, what):
    """fn(z) with z's columns split over the mesh's 'tp' ranks: each rank
    applies fn to its block of columns, then one all_gather; fn(z) whole
    where there is no mesh or the columns do not split evenly."""
    cols = comm.row_range(z.shape[-1], mesh)
    if cols is None:
        return fn(z)
    return comm.all_gather(fn(z[..., cols[0] : cols[1]]), mesh, axis=-1, what=what)


def _use_two_stage(n, cfg, iscomplex, compute_is_f64):
    """Whether the two-stage reduction (sbrd + bulge chase) replaces the
    one-stage Householder loop: the JAX package's rule (see the module
    docstring), its thresholds not re-tuned for this card."""
    if iscomplex or cfg.tridiag_mode == "one":
        return False
    if cfg.tridiag_mode == "two":
        return True
    return compute_is_f64 and n >= cfg.two_stage_min_n


def _reduction(n, cfg, iscomplex, compute_is_f64):
    """(two_stage, npad): the reduction a solve of size n takes and the
    size it pads to (two-stage needs npad >= 3 * band, else one-stage)."""
    two_stage = _use_two_stage(n, cfg, iscomplex, compute_is_f64)
    nb = cfg.band if two_stage else cfg.nb_tridiag
    npad = -(-n // nb) * nb
    if two_stage and npad < 3 * cfg.band:
        two_stage = False
        npad = -(-n // cfg.nb_tridiag) * cfg.nb_tridiag
    return two_stage, npad


def takes_two_stage(n, dtype, cfg):
    """Whether a solve of size n on ``dtype`` operands (mixed mode
    included) reduces by the two-stage route (the kernels K5, K7, K9,
    each one launch for a whole batch) rather than the one-stage one."""
    rdt = dtype.to_real()
    mixed = cfg.compute_dtype == "float32" and rdt == torch.float64
    if cfg.stedc_backend == "xla":
        return False
    return _reduction(n, cfg, dtype.is_complex, rdt == torch.float64 and not mixed)[0]


def _tridiag_reduce(a_p, cfg, two_stage, mesh=None):
    """Reduce symmetric/Hermitian ``a_p`` (padded) to tridiagonal (d, e);
    returns (d, e, back) with ``back(z)`` applying the accumulated
    orthogonal transform Q to tridiagonal eigenvector columns z. A leading
    axis of ``a_p`` is a batch of problems, reduced together on either
    route. ``mesh``: the reduction's rows (where they split evenly) and
    the back-transform's columns (where they do) split over its 'tp' ranks
    (module docstring)."""
    if two_stage:
        from eigensolver_gpu_torch.ops.sb2st import apply_q2, bulge_chase, dense_to_band
        from eigensolver_gpu_torch.ops.sbrd import apply_q1, sbrd

        npad = a_p.shape[-1]
        # JAX passes panel_kernel=mesh is None and cfg.mosaic_kernels: its
        # Pallas panel cannot be SPMD-partitioned; K5 runs on every rank's
        # own gathered panel, so it stays on under a mesh
        ab, vs, ts = sbrd(a_p, band=cfg.band, bucket=512, panel_kernel=cfg.mosaic_kernels,
                          mesh=_maybe_row_shard(a_p, mesh))
        band = dense_to_band(ab, cfg.band)
        if cfg.mosaic_kernels:
            from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel

            d, e, vt, taut = bulge_chase_kernel(band, cfg.band)
        else:
            d, e, vt, taut = bulge_chase(band, cfg.band)
        # replay group size: the JAX default, 3*band in fp32 (l_win = 127
        # at band 32) and band in fp64
        g = cfg.replay_g or (3 * cfg.band if ab.dtype == torch.float32 else cfg.band)

        def replay(z):
            if cfg.mosaic_kernels:
                from eigensolver_gpu_torch.ops.replay import apply_q2_kernel

                z2 = apply_q2_kernel(vt, taut, z, npad, cfg.band, g=g)
            else:
                z2 = apply_q2(vt, taut, z, npad, cfg.band, g=g)
            return apply_q1(vs, ts, z2)

        return d, e, lambda z: _by_columns(replay, z, mesh, "back")

    a_packed, d, e, tau = sytrd(
        a_p, nb=cfg.nb_tridiag, bucket=256, use_pallas=cfg.use_pallas,
        mesh=_maybe_row_shard(a_p, mesh),
    )

    def back(z):
        return _by_columns(lambda zc: unmtr(a_packed, tau, zc, nb=cfg.nb_back), z, mesh, "back")

    return d, e, back


def sort_pairs(w, *vecs):
    """Eigenvalues ascending with their vector columns (leading axes: a
    batch, each item sorted on its own)."""
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.take_along_dim(w, order, -1),
            *(torch.take_along_dim(v, order[..., None, :], -1) for v in vecs))


@highest_precision
def syevdx(a, il=1, iu=None, cfg: SolverConfig = DEFAULT_CONFIG, mesh=None):
    """Eigenpairs il..iu (1-based, ascending, LAPACK RANGE='I') of dense
    symmetric/Hermitian ``a``. Returns (w (m,) real, z (n, m)), on the
    device of ``a``. Leading axes of ``a`` are a batch of problems, solved
    together (on the two-stage route the kernels take one batch axis).

    mesh: a ('dp', 'tp') DeviceMesh; every rank passes the whole ``a`` of
    one problem and gets the whole result, the dominant stages split over
    'tp' (module docstring)."""
    n = a.shape[-1]
    if iu is None:
        iu = n
    if not (1 <= il <= iu <= n):
        raise ValueError(f"need 1 <= il <= iu <= n, got il={il}, iu={iu}, n={n}")
    if mesh is not None and a.dim() != 2:
        raise ValueError(f"syevdx with a mesh takes one problem, got {tuple(a.shape)}")
    iscomplex = a.is_complex()

    if cfg.stedc_backend == "xla":
        with trace_range("syevdx_xla"):
            w, z = eigh_or_nan(a)
            return w[..., il - 1 : iu], z[..., il - 1 : iu]

    rdt = a.real.dtype
    mixed = cfg.compute_dtype == "float32" and rdt == torch.float64
    two_stage, npad = _reduction(n, cfg, iscomplex, rdt == torch.float64 and not mixed)

    if mixed:
        # O(n^3) factorization stages in fp32, then Ogita-Aishima sweeps
        # against the fp64 matrix recover fp64 accuracy (ops/refine.py).
        # The fp32 pipeline computes the full spectrum (stedc needs it);
        # refinement runs on the selected block + cluster margin only.
        lo_dt = torch.complex64 if iscomplex else torch.float32
        a_p = _pad_decoupled(a.to(lo_dt), npad)
        with trace_range("syevdx_fp32"):
            d, e, back = _tridiag_reduce(a_p, cfg, two_stage, mesh=mesh)
            w_all, q_tri = stedc(d, e, leaf=cfg.stedc_leaf, mesh=mesh)
            z_tri = q_tri.to(lo_dt) if iscomplex else q_tri
            x32 = back(z_tri[..., :n])[..., :n, :]
        sel0 = max(0, il - 1 - cfg.refine_margin)
        sel1 = min(n, iu + cfg.refine_margin)
        w, x = refine_eigh(
            a, x32.to(a.dtype), sweeps=cfg.refine_iters,
            chunk=2048 if n >= 8192 else None,
            sel=(sel0, sel1 - sel0), w0=w_all[..., :n].to(rdt),
            extra_max=cfg.refine_extra_max, mesh=mesh,
        )
        w, x = sort_pairs(w, x)
        lo = il - 1 - sel0
        return w[..., lo : lo + (iu - il + 1)], x[..., lo : lo + (iu - il + 1)]

    a_p = _pad_decoupled(a, npad)
    with trace_range("syevdx"):
        d, e, back = _tridiag_reduce(a_p, cfg, two_stage, mesh=mesh)
        w_all, q_tri = stedc(d, e, leaf=cfg.stedc_leaf, mesh=mesh)
        # the decoupled padding sorts above the true spectrum, so indices
        # il..iu of the first n entries are the requested pairs
        w = w_all[..., il - 1 : iu]
        z_tri = q_tri[..., il - 1 : iu]
        if iscomplex:
            z_tri = z_tri.to(a.dtype)
        return w, back(z_tri)[..., :n, :]
