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
  * ``gemm='native'``, the port's default and the card's, runs the fp64
    products as native fp64 ``torch.matmul``. ``gemm='ozaki'``, the JAX
    package's default (a workaround for its emulated fp64), runs the real
    fp64 sweeps' products as exact digit gemms (ops/ozaki.py), as JAX's
    ``_resolve_mm`` does: only on real fp64 input, the plain product
    otherwise. Which route the card should take by default is for a
    benchmark to decide;
  * the defect-gated escalation is a host loop that reads the defect
    after each sweep (one device sync per extra sweep, against five
    large gemms per sweep) instead of a fixed-trip masked loop, which
    would always pay ``extra_max`` sweeps; over a batch of problems
    (leading axes) it sweeps while any item's defect exceeds that item's
    tolerance, and the items that stopped keep their state
    (:func:`escalate`);
  * ``mesh`` (JAX: row sharding of a, b and x over 'tp', the partitioner
    owning the contraction sums) splits each sweep's products over the
    rows: A X_blk and B X_blk are the rank's rows of A and B times the
    whole block, the Gram products X^H (B X_blk) and X^H (A X_blk) the
    rank's partial sums over its rows, added by one all_reduce, and the
    correction X E the rank's rows, gathered by one all_gather; every rank
    holds the whole x between sweeps, and the reduced grams are the same
    on every rank, so each takes the same escalation sweeps. As in JAX,
    ``gemm='ozaki'`` takes the plain product under a mesh.
"""

from __future__ import annotations

import functools

import torch

from eigensolver_gpu_torch.ops.ozaki import ozaki_matmul_chunked
from eigensolver_gpu_torch.parallel import comm
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import count, trace_range

_EPS32 = torch.finfo(torch.float32).eps


def _mm_chunked(x, y, chunk):
    """x @ y with y's columns in sequential chunks, so only one chunk's
    temporaries are alive at once."""
    m = y.shape[-1]
    if chunk is None or chunk >= m or m % chunk != 0:
        return x @ y
    return torch.cat([x @ y[..., c : c + chunk] for c in range(0, m, chunk)], -1)


def _renorm(m_gram, e, sel0, ms):
    """Second-order B-norm correction, gemm-free: 1/sqrt(diag((I+E)^H M
    (I+E))) for the ms block columns, from the gram M = X^H B X_blk
    already in hand (see the JAX twin for the derivation)."""
    d = (
        torch.diagonal(m_gram[..., sel0 : sel0 + ms, :], dim1=-2, dim2=-1).real
        + 2.0 * torch.sum(e.conj() * m_gram, dim=-2).real
        + torch.sum((e.conj() * e).real, dim=-2)
    )
    return 1.0 / torch.sqrt(torch.clamp_min(d, torch.finfo(d.dtype).tiny))


def _correct_block(gram, s, sel0, ms, w_rows):
    """Shared tail of one selected-block sweep: from gram = X^H M X_blk
    (M = B or I) and s = X^H A X_blk, build the correction E (n_all, ms),
    the block column scales, the updated eigenvalue estimates and the
    marginal-pair defect (leading axes: a batch, one defect an item).

    Returns (e, sc, lam, w_rows', defect)."""
    dt = gram.dtype
    dev = gram.device
    eps = torch.finfo(w_rows.dtype).eps
    n_all = gram.shape[-2]
    rows = torch.arange(n_all, device=dev)[:, None]
    cols = torch.arange(ms, device=dev)[None, :]
    is_self = rows == cols + sel0
    inblk = (rows >= sel0) & (rows < sel0 + ms)

    r = is_self.to(dt) - gram
    lam = torch.diagonal(s[..., sel0 : sel0 + ms, :], dim1=-2, dim2=-1).real / (
        1.0 - torch.diagonal(r[..., sel0 : sel0 + ms, :], dim1=-2, dim2=-1).real
    )
    w_rows = w_rows.clone()
    w_rows[..., sel0 : sel0 + ms] = lam
    denom = lam[..., None, :] - w_rows[..., :, None]
    anorm = w_rows.abs().amax(-1)[..., None, None]  # one an item
    sep_in = torch.clamp_min(1e3 * eps * anorm, _EPS32 * anorm)
    # out-of-block lambdas carry the fp32 pipeline's O(eps32*anorm)
    # error -- widen the cluster floor there
    sep = torch.where(inblk, sep_in, torch.clamp_min(sep_in, 64 * _EPS32 * anorm))
    ok = denom.abs() > sep
    safe = torch.where(ok, denom, torch.ones_like(denom))
    num = s + lam[..., None, :] * r
    e = torch.where(ok, num / safe, r / 2)
    sc = _renorm(gram, e, sel0, ms)[..., None, :]
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
    defect = torch.sqrt(torch.amax(torch.sum(pred * pred, dim=-2), dim=-1))
    return e, sc, lam, w_rows, defect


def _sweep(a, b, x, sel, w_rows, chunk=None, mm=_mm_chunked, mm_dx=None, mesh=None):
    """One sweep on the selected block (the JAX package's _sweep_eigh and
    _sweep_gevp in one); updates only columns sel0..sel0+ms of the full
    basis x (n, n_all). ``b`` None is the standard problem
    (R = I - X^H X_blk), else R = I - X^H B X_blk. ``mm(x, y, chunk)`` is
    the product, ``mm_dx`` (default ``mm``) the correction's X @ E.
    ``mesh``: the products split over its 'tp' ranks by rows (module
    docstring). Returns (x', lam, w_rows', defect)."""
    sel0, ms = sel
    xs = x[..., sel0 : sel0 + ms]
    split = comm.row_range(x.shape[-2], mesh) is not None
    if not split:
        xh = x.mH
        gram = mm(xh, xs if b is None else mm(b, xs, chunk), chunk)
        s = mm(xh, mm(a, xs, chunk), chunk)
    else:
        rows = lambda m: comm.row_block(m, mesh)
        xh = rows(x).mH
        mx = rows(xs) if b is None else mm(rows(b), xs, chunk)
        gram, s = comm.all_reduce(
            torch.stack([mm(xh, mx, chunk), mm(xh, mm(rows(a), xs, chunk), chunk)]),
            mesh, what="refine")
    e, sc, lam, w_rows, defect = _correct_block(gram, s, sel0, ms, w_rows)
    x = x.clone()
    if not split:
        dx = (mm_dx or mm)(x, e, chunk)
    else:
        dx = comm.all_gather((mm_dx or mm)(rows(x), e, chunk), mesh, what="refine")
    x[..., sel0 : sel0 + ms] = (xs + dx) * sc
    return x, lam, w_rows, defect


def _resolve_mm(gemm, dt, mesh=None):
    """(mm, mm_dx) of the fp64 sweeps: the ozaki digit product on real fp64
    input under ``gemm='ozaki'`` without a mesh, with the correction X @ E
    at 28 bits (its error is relative to |E|, below the sweep's own
    quadratic term); the plain product otherwise (JAX's ``_resolve_mm``,
    whose gate keeps ozaki off sharded runs)."""
    if gemm == "ozaki" and dt == torch.float64 and mesh is None:
        return ozaki_matmul_chunked, functools.partial(ozaki_matmul_chunked, bits=28)
    return _mm_chunked, None


def escalate(one_sweep, state, defect, tol, extra_max):
    """Defect-gated extra sweeps: at most ``extra_max`` more while
    ``defect > tol``. ``one_sweep(state)`` returns (state', defect');
    ``state`` is a tuple of tensors whose leading axes, like those of
    ``defect`` and ``tol``, are a batch of problems (none for one).

    Each item sweeps while its own defect exceeds its own tolerance, and
    an item that stops keeps its state: the semantics of the JAX package's
    ``lax.while_loop`` under ``vmap``. The test is read on the host once a
    sweep, for all items at once; a sweep in which every item is active
    takes the new state whole, so one problem runs exactly as before.
    Each sweep run counts one ``refine_extra_sweeps`` (utils/tracing.py)."""
    for _ in range(extra_max):
        active = defect > tol
        flags = active.reshape(-1).tolist()  # one device sync a sweep
        if not any(flags):
            break
        count("refine_extra_sweeps")
        new_state, new_defect = one_sweep(state)
        if all(flags):
            state, defect = new_state, new_defect
            continue
        keep = lambda t: active.reshape(active.shape + (1,) * (t.dim() - active.dim()))
        state = tuple(torch.where(keep(s), ns, s) for ns, s in zip(new_state, state))
        defect = torch.where(active, new_defect, defect)
    return state, defect


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
        count("refine_extra_sweeps")
        x, w, w_rows, defect = one_sweep(x, w_rows)
        extra_max -= 1
    if extra_max > 0 and defect is not None and is64:
        # tolerance sits well above the defect's gram-noise floor and
        # well below a one-sweep-short defect; one an item
        tol = 100.0 * torch.finfo(torch.float64).eps * (n**0.5) * w_rows.abs().amax(-1)

        def step(state):
            x, w_rows = state
            x, _, w_rows, defect = one_sweep(x, w_rows)
            return (x, w_rows), defect

        (x, w_rows), defect = escalate(step, (x, w_rows), defect, tol, extra_max)
        w = None
    return x, w, w_rows


def _check_gemm(gemm):
    if gemm not in ("native", "ozaki"):
        raise ValueError(f"unknown gemm {gemm!r}")


def _refine(a, b, x, sweeps, coarse_first, chunk, sel, w0, extra_max, name, gemm, mesh=None):
    """Body shared by refine_gevp and refine_eigh (``b`` None). Returns
    (w or None, w_rows, x) after all sweeps."""
    dt = a.dtype
    x = x.to(dt)
    n, m = x.shape[-2:]
    sel0, ms = sel
    rdt = a.real.dtype
    if w0 is None:
        if ms < m:
            raise ValueError("sel with a strict subset requires w0")
        w0 = torch.zeros(x.shape[:-2] + (m,), dtype=rdt, device=a.device)
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
                x32, _, w32, _ = _sweep(a32, b32, x32, sel, w32, mesh=mesh)
            x = x32.to(dt)
            w_rows = w32.to(rdt)
            n_full = max(sweeps - n_coarse, 1)
        else:
            n_full = sweeps
        mm, mm_dx = _resolve_mm(gemm, dt, mesh)
        return _run_sweeps(
            lambda x, w_rows: _sweep(a, b, x, sel, w_rows, chunk, mm, mm_dx, mesh),
            x, w_rows, n_full, extra_max, n, is64,
        )


@highest_precision
def refine_gevp(a, b, x, sweeps=2, coarse_first=True, chunk=None,
                gemm="native", sel=None, w0=None, extra_max=0, mesh=None):
    """Refine generalized eigenpairs of (a, b) from the approximate
    B-orthonormal full basis ``x`` (n x n, ascending eigenvalue order).

    sel: optional (sel0, ms) -- refine/return only that block (selected
    range + cluster margin; per-sweep cost ~n^2*ms). w0: full-length
    fp32-pipeline eigenvalue estimates, required with a strict-subset
    sel. coarse_first: all but the last sweep (at most 2) run in the
    32-bit dtype. extra_max: defect-gated extra fp64 sweeps.
    gemm: 'native' (the default, here and on the card: fp64
    torch.matmul) or 'ozaki' (the JAX default: exact digit gemms on real
    fp64 input, ops/ozaki.py); anything else is a ValueError.
    mesh: split the products over its 'tp' ranks by rows (module
    docstring); every rank returns the whole result.
    Returns (w (ms,), x_block (n, ms)).
    """
    _check_gemm(gemm)
    if sel is None:
        sel = (0, x.shape[-1])
    sel0, ms = sel
    x, w, w_rows = _refine(a, b, x, sweeps, coarse_first, chunk, sel, w0,
                           extra_max, "refine_gevp", gemm, mesh)
    if w is None:
        w = w_rows[..., sel0 : sel0 + ms]
    return w, x[..., sel0 : sel0 + ms]


@highest_precision
def refine_eigh(a, x, sweeps=2, coarse_first=True, chunk=None,
                gemm="native", sel=None, w0=None, extra_max=0, mesh=None):
    """Refine eigenvectors of dense symmetric/Hermitian ``a`` from the
    approximate full basis ``x`` (n x m, ascending order); returns
    (w (ms,), x_block (n, ms)) for the selected block (all of x when
    sel is None). Arguments as in refine_gevp; the block is finished with
    a column normalization and its Rayleigh quotients (under a mesh, the
    rank's rows of A times the block, summed over the ranks).
    """
    _check_gemm(gemm)
    if sel is None:
        sel = (0, x.shape[-1])
    sel0, ms = sel
    x, _, _ = _refine(a, None, x, sweeps, coarse_first, chunk, sel, w0,
                      extra_max, "refine_eigh", gemm, mesh)
    xs = x[..., sel0 : sel0 + ms]
    xs = xs / torch.linalg.vector_norm(xs, dim=-2)[..., None, :]
    if comm.row_range(xs.shape[-2], mesh) is None:
        w = torch.sum(xs.conj() * (a @ xs), dim=-2).real
    else:
        w = comm.all_reduce(torch.sum(comm.row_block(xs, mesh).conj()
                                      * (comm.row_block(a, mesh) @ xs), dim=-2).real,
                            mesh, what="refine")
    return w, xs
