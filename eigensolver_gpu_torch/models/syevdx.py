"""Standard symmetric/Hermitian eigensolver with index-range selection
(twin of eigensolver_gpu_tpu/models/syevdx.py).

Pipeline (reference dsyevd_gpu.F90:32-128 / zheevd_gpu.F90:32-130):
tridiagonalize -> tridiagonal eigensolve -> select columns il..iu ->
back-transform. As in the JAX package, the tridiagonal solve runs on the
device (ops/stedc.py) instead of a host LAPACK call, and A is not
destroyed.

For Hermitian input the tridiagonal matrix is real; the real stedc
output is cast back to the complex dtype only for the WY back-transform.

Not ported yet: the two-stage reduction (sbrd + bulge chase).
``tridiag_mode='two'`` raises NotImplementedError on real input (complex
input is one-stage in every mode, as in the JAX package), and ``'auto'``
stays one-stage at every size. The JAX ``'auto'`` switches to two-stage for
fp64 compute at n >= ``two_stage_min_n`` (4096), so a pure-fp64 solve of
that size takes another reduction here than there until the two-stage
path is ported: a missing branch, not a different result (both
reductions give the same eigenpairs to tolerance). ``mesh`` (row
sharding) is not carried either.
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


def _tridiag_reduce(a_p, cfg):
    """Reduce symmetric/Hermitian ``a_p`` (padded) to tridiagonal (d, e);
    returns (d, e, back) with ``back(z)`` applying the accumulated
    orthogonal transform Q to tridiagonal eigenvector columns z.
    One-stage only (see the module docstring)."""
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
    # complex input is one-stage whatever the mode, as in the JAX package
    if cfg.tridiag_mode == "two" and not iscomplex:
        raise NotImplementedError(
            "tridiag_mode='two' (two-stage reduction) is not ported yet"
        )

    rdt = a.real.dtype
    mixed = cfg.compute_dtype == "float32" and rdt == torch.float64
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
            d, e, back = _tridiag_reduce(a_p, cfg)
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
        d, e, back = _tridiag_reduce(a_p, cfg)
        w_all, q_tri = stedc(d, e, leaf=cfg.stedc_leaf)
        # the decoupled padding sorts above the true spectrum, so indices
        # il..iu of the first n entries are the requested pairs
        w = w_all[il - 1 : iu]
        z_tri = q_tri[:, il - 1 : iu]
        if iscomplex:
            z_tri = z_tri.to(a.dtype)
        return w, back(z_tri)[:n]
