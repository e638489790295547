"""Mixed-precision eigenpair refinement (Ogita-Aishima iteration; twin of
eigensolver_gpu_tpu/ops/refine.py, the real/complex-dtype counterpart of
ops/refine_planar.py).

The O(n^3) factorization stages run in fp32 and fp64 accuracy is
recovered by refinement against the fp64 matrices. Given approximate
eigenvectors X of symmetric/Hermitian A (Ogita & Aishima 2018),

    R = I - X^H X          (orthogonality defect; X^H B X generalized)
    S = X^H A X            (near-diagonal)
    lambda_i = S_ii / (1 - R_ii)
    E_ij = (S_ij + lambda_j R_ij) / (lambda_j - lambda_i)   (separated)
    E_ij = R_ij / 2                                          (else, and i=j)
    X <- X + X E

Only ``ms`` selected columns (+ cluster margin) are corrected, against
the FULL fp32 basis (grams are (n_all, ms), cost ~n^2 ms per sweep), with
the fp32 pipeline's eigenvalues serving the out-of-block denominators
under a widened cluster floor. Each sweep also returns a ``defect``, the
predicted post-sweep coupling of marginally separated pairs; while it
exceeds the residual contract, up to ``extra_max`` more fp64 sweeps run.

Port differences:
  * the fp64 products are native fp64 ``torch.matmul``. The JAX package
    defaults to ``gemm='ozaki'`` (bf16 digit products, a workaround for
    emulated fp64); here the default is ``'native'`` and ``gemm='ozaki'``
    raises NotImplementedError until ops/ozaki.py is ported;
  * the defect-gated escalation is a host loop that reads the defect
    after each sweep (one device sync per extra sweep, against five
    large gemms per sweep) instead of a fixed-trip masked loop, which
    would always pay ``extra_max`` sweeps;
  * ``mesh`` (row sharding) is not carried: sharding is not ported yet.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range

_EPS32 = torch.finfo(torch.float32).eps


def _mm_chunked(x, y, chunk):
    """x @ y with y's columns in sequential chunks, so only one chunk's
    temporaries are alive at once."""
    m = y.shape[1]
    if chunk is None or chunk >= m or m % chunk != 0:
        return x @ y
    return torch.cat([x @ y[:, c : c + chunk] for c in range(0, m, chunk)], 1)


def _renorm(m_gram, e, sel0, ms):
    """Second-order B-norm correction, gemm-free: 1/sqrt(diag((I+E)^H M
    (I+E))) for the ms block columns, from the gram M = X^H B X_blk
    already in hand (see the JAX twin for the derivation)."""
    d = (
        torch.diagonal(m_gram[sel0 : sel0 + ms]).real
        + 2.0 * torch.sum(e.conj() * m_gram, dim=0).real
        + torch.sum((e.conj() * e).real, dim=0)
    )
    return 1.0 / torch.sqrt(torch.clamp_min(d, torch.finfo(d.dtype).tiny))


def _correct_block(gram, s, sel0, ms, w_rows):
    """Shared tail of one selected-block sweep: from gram = X^H M X_blk
    (M = B or I) and s = X^H A X_blk, build the correction E (n_all, ms),
    the block column scales, the updated eigenvalue estimates and the
    marginal-pair defect.

    Returns (e, sc, lam, w_rows', defect)."""
    dt = gram.dtype
    dev = gram.device
    eps = torch.finfo(w_rows.dtype).eps
    n_all = gram.shape[0]
    rows = torch.arange(n_all, device=dev)[:, None]
    cols = torch.arange(ms, device=dev)[None, :]
    is_self = rows == cols + sel0
    inblk = (rows >= sel0) & (rows < sel0 + ms)

    r = is_self.to(dt) - gram
    lam = torch.diagonal(s[sel0 : sel0 + ms]).real / (
        1.0 - torch.diagonal(r[sel0 : sel0 + ms]).real
    )
    w_rows = w_rows.clone()
    w_rows[sel0 : sel0 + ms] = lam
    denom = lam[None, :] - w_rows[:, None]
    anorm = w_rows.abs().max()
    sep_in = torch.clamp_min(1e3 * eps * anorm, _EPS32 * anorm)
    # out-of-block lambdas carry the fp32 pipeline's O(eps32*anorm)
    # error -- widen the cluster floor there
    sep = torch.where(inblk, sep_in, torch.clamp_min(sep_in, 64 * _EPS32 * anorm))
    ok = denom.abs() > sep
    safe = torch.where(ok, denom, torch.ones_like(denom))
    num = s + lam[None, :] * r
    e = torch.where(ok, num / safe, r / 2)
    sc = _renorm(gram, e, sel0, ms)[None, :]
    # defect = predicted post-sweep residual per column (l2 over rows,
    # max over columns); cluster-branch pairs are suppressed by the
    # max(.., sep): their gap-level floor must not drive escalation
    delta = torch.where(inblk, 1e3 * eps * anorm, 64 * _EPS32 * anorm)
    absnum = num.abs()
    pred = torch.where(
        is_self,
        torch.zeros_like(absnum),
        torch.minimum(absnum, (delta + absnum) * absnum / torch.maximum(denom.abs(), sep)),
    )
    defect = torch.sqrt(torch.max(torch.sum(pred * pred, dim=0)))
    return e, sc, lam, w_rows, defect


def _sweep(a, b, x, sel, w_rows, chunk=None):
    """One sweep on the selected block (the JAX package's _sweep_eigh and
    _sweep_gevp in one); updates only columns sel0..sel0+ms of the full
    basis x (n, n_all). ``b`` None is the standard problem
    (R = I - X^H X_blk), else R = I - X^H B X_blk.
    Returns (x', lam, w_rows', defect)."""
    sel0, ms = sel
    xs = x[:, sel0 : sel0 + ms]
    xh = x.mH
    gram = _mm_chunked(xh, xs if b is None else _mm_chunked(b, xs, chunk), chunk)
    s = _mm_chunked(xh, _mm_chunked(a, xs, chunk), chunk)
    e, sc, lam, w_rows, defect = _correct_block(gram, s, sel0, ms, w_rows)
    x = x.clone()
    x[:, sel0 : sel0 + ms] = (xs + _mm_chunked(x, e, chunk)) * sc
    return x, lam, w_rows, defect


def _run_sweeps(one_sweep, x, w_rows, n_full, extra_max, n, is64):
    """Static sweeps + defect-gated escalation (shared by refine_gevp /
    refine_eigh). Returns (x, w, w_rows) with w None when the last sweep
    was an escalation sweep (read it from w_rows)."""
    w = None
    defect = None
    for _ in range(n_full):
        x, w, w_rows, defect = one_sweep(x, w_rows)
    if defect is None and extra_max > 0 and is64:
        # sweeps=0 with escalation enabled: the gate needs one measured
        # sweep; spend the first escalation sweep here
        x, w, w_rows, defect = one_sweep(x, w_rows)
        extra_max -= 1
    if extra_max > 0 and defect is not None and is64:
        # tolerance sits well above the defect's gram-noise floor and
        # well below a one-sweep-short defect
        tol = 100.0 * torch.finfo(torch.float64).eps * (n**0.5) * w_rows.abs().max()
        it = 0
        while it < extra_max and bool(defect > tol):
            x, _, w_rows, defect = one_sweep(x, w_rows)
            it += 1
        w = None
    return x, w, w_rows


def _check_gemm(gemm):
    if gemm == "ozaki":
        raise NotImplementedError(
            "gemm='ozaki' needs ops/ozaki.py, which is not ported yet; "
            "use gemm='native'"
        )
    if gemm != "native":
        raise ValueError(f"unknown gemm {gemm!r}")


def _refine(a, b, x, sweeps, coarse_first, chunk, sel, w0, extra_max, name):
    """Body shared by refine_gevp and refine_eigh (``b`` None). Returns
    (w or None, w_rows, x) after all sweeps."""
    dt = a.dtype
    x = x.to(dt)
    n, m = x.shape
    sel0, ms = sel
    rdt = a.real.dtype
    if w0 is None:
        if ms < m:
            raise ValueError("sel with a strict subset requires w0")
        w0 = torch.zeros((m,), dtype=rdt, device=a.device)
    w_rows = w0.to(rdt)
    is64 = rdt == torch.float64

    with trace_range(name):
        if coarse_first and sweeps > 1 and is64:
            lo = torch.complex64 if a.is_complex() else torch.float32
            a32, x32 = a.to(lo), x.to(lo)
            b32 = None if b is None else b.to(lo)
            w32 = w_rows.float()
            # cap coarse sweeps at 2: iterations beyond that go to fp64
            n_coarse = min(sweeps - 1, 2)
            for _ in range(n_coarse):
                x32, _, w32, _ = _sweep(a32, b32, x32, sel, w32)
            x = x32.to(dt)
            w_rows = w32.to(rdt)
            n_full = max(sweeps - n_coarse, 1)
        else:
            n_full = sweeps
        return _run_sweeps(
            lambda x, w_rows: _sweep(a, b, x, sel, w_rows, chunk),
            x, w_rows, n_full, extra_max, n, is64,
        )


@highest_precision
def refine_gevp(a, b, x, sweeps=2, coarse_first=True, chunk=None,
                gemm="native", sel=None, w0=None, extra_max=0):
    """Refine generalized eigenpairs of (a, b) from the approximate
    B-orthonormal full basis ``x`` (n x n, ascending eigenvalue order).

    sel: optional (sel0, ms) -- refine/return only that block (selected
    range + cluster margin; per-sweep cost ~n^2*ms). w0: full-length
    fp32-pipeline eigenvalue estimates, required with a strict-subset
    sel. coarse_first: all but the last sweep (at most 2) run in the
    32-bit dtype. extra_max: defect-gated extra fp64 sweeps.
    Returns (w (ms,), x_block (n, ms)).
    """
    _check_gemm(gemm)
    if sel is None:
        sel = (0, x.shape[1])
    sel0, ms = sel
    x, w, w_rows = _refine(a, b, x, sweeps, coarse_first, chunk, sel, w0,
                           extra_max, "refine_gevp")
    if w is None:
        w = w_rows[sel0 : sel0 + ms]
    return w, x[:, sel0 : sel0 + ms]


@highest_precision
def refine_eigh(a, x, sweeps=2, coarse_first=True, chunk=None,
                gemm="native", sel=None, w0=None, extra_max=0):
    """Refine eigenvectors of dense symmetric/Hermitian ``a`` from the
    approximate full basis ``x`` (n x m, ascending order); returns
    (w (ms,), x_block (n, ms)) for the selected block (all of x when
    sel is None). Arguments as in refine_gevp; the block is finished with
    a column normalization and its Rayleigh quotients.
    """
    _check_gemm(gemm)
    if sel is None:
        sel = (0, x.shape[1])
    sel0, ms = sel
    x, _, _ = _refine(a, None, x, sweeps, coarse_first, chunk, sel, w0,
                      extra_max, "refine_eigh")
    xs = x[:, sel0 : sel0 + ms]
    xs = xs / torch.linalg.vector_norm(xs, dim=0)[None, :]
    w = torch.sum(xs.conj() * (a @ xs), dim=0).real
    return w, xs
