"""On-device divide-and-conquer symmetric tridiagonal eigensolver (twin of
eigensolver_gpu_tpu/ops/stedc.py).

Replaces the reference's CPU escape hatch (dsyevd_gpu.F90:99: the
tridiagonal goes to the host for LAPACK dstedc). The merge tree runs on
the device: leaves are batched dense eighs, each level merges all its
pairs at once along a leading batch dimension (the JAX package's vmap),
the secular equation is solved for every root together by a
safeguarded rational iteration, and the eigenvectors are assembled with
one gemm per merge.

Design decisions carried over from the JAX package (see its docstring):
deflation by masking, separation of surviving poles to a minimum gap
instead of dlaed2's Givens chain, and the Gu/Eisenstat recomputed z.

The secular iteration stops by JAX's rule for its live lanes: a lane
whose pole survived deflation is done once it has converged (|f| at its
evaluation's roundoff floor) or its bracket has collapsed to
eps * max(|lo|, |hi|) + eps * gap_min; a deflated lane counts as done
from the start; the loop ends when every lane of the call is done, or at
the ``_secular_iters`` ceiling (35 sweeps in fp32, 60 in fp64). The
deflation-aware assembly (``compact``)
is JAX's: alive poles first, the update gemm at the smallest of four
bucket sizes covering the alive count, the deflated columns passed
through; ``stedc`` takes it where JAX does, at the levels of at most two
pairs and at the fold merges.

Port differences:
  * deflated lanes do not hold the loop (JAX's ``while_loop`` tests every
    lane's bracket). Such a lane has z = 0: it bisects toward a pole
    that is not there and never meets the bracket test, so under JAX's
    test every merge that deflates anything runs to the ceiling. Its
    root is thrown away (w takes the pole there) and the Loewner and
    assembly masks never read it, so the rule changes the sweep count
    and not the roots: the sweeps it drops move live lanes only inside
    brackets already collapsed to eps, as below. ``alive`` is the same on
    every rank of a mesh, and a merge with no deflation stops as before;
  * the done flag is computed on the device and read on the host every
    ``STOP_EVERY`` sweeps (JAX tests it before every sweep inside a
    ``while_loop``), so a merge may run up to ``STOP_EVERY - 1`` sweeps
    past JAX's stop. Such sweeps leave converged lanes where they are (a
    converged lane re-running the step is a no-op: the safeguard
    invariant) and move the others only inside brackets already
    collapsed to eps, so the roots agree with JAX's within that bracket
    width (eps relative, the eps * gap_min floor near zero). A batch
    (problems and pairs of a level) stops when its last lane is done,
    as under JAX's vmap. ``stedc.sweeps`` holds the sweeps of each merge
    of the last call, in order;
  * ``compact`` reads the alive count on the host to choose the bucket
    (JAX's ``lax.switch`` chooses on the device): one read a compact
    merge, a handful a solve. Under a batch each item gets its own
    bucket, as under JAX's vmap, and the items of one bucket share one
    gemm (at most four a merge). ``stedc.compact`` holds (n2, alive
    counts, buckets) of each compact merge of the last call;
  * under a ``mesh`` (JAX's ``stedc(mesh=...)``) the levels of at most two
    pairs a problem and the fold merges take the full assembly, as JAX's
    ``compact=mesh is None`` does, and split their O(n2^2) work over the
    'tp' ranks where n2 divides: each rank runs the secular iteration for
    its block of roots (rows of the pole-difference matrix), the Loewner
    products for the same block of columns and the assembly gemm
    ``Q . U`` for the same block of columns of U; the roots, the
    recomputed z and the assembled columns are gathered (two vector
    all_gathers and one matrix all_gather a merge), and the stop test is
    an all_reduce of the ranks' done flags, so every rank runs the same
    sweeps. The lower levels run whole on every rank (JAX shards their
    pair axis);
  * leaves follow the JAX rule: torch.linalg.eigh in fp32 (the JAX 'xla'
    leaf), the batched cyclic Jacobi of ops/jacobi.py in fp64 (for an
    even leaf size, else dense eigh).

Input: d (n,), e (n-1,) real, or a batch d (B, n), e (B, n-1). Output:
(w, q) with w ascending and q orthogonal, T q = q diag(w),
T = tridiag(e, d, e), with the batch axis in front when given one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from eigensolver_gpu_torch.ops.jacobi import jacobi_eigh
from eigensolver_gpu_torch.parallel import comm
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


# sweeps between two host reads of the secular iteration's done flag
STOP_EVERY = 4


def _secular_iters(dt):
    """Safeguarded-iteration ceiling: worst-case lanes degrade to bisection,
    so the count must bottom out the dtype's precision."""
    return 60 if dt == torch.float64 else 35


def _buckets(n2):
    """The compact assembly's gemm sizes: the quarters of n2 rounded up to
    a multiple of 128 (at most n2), and n2."""
    sizes = sorted({min(n2, -(-(n2 * (i + 1) // 4) // 128) * 128) for i in range(4)})
    return sizes if sizes[-1] == n2 else sizes + [n2]


def _merge_pair(d1, q1, d2, q2, beta, gap_scale, compact=False, mesh=None):
    """Merge batches of solved blocks coupled by off-diagonal ``beta``.

    d1 (B, m), q1 (B, m, m), d2 (B, m2), q2 (B, m2, m2), beta (B,),
    gap_scale (B,) (each pair's problem's scale):
    [[T1, beta e e^T], [.., T2]] = blockdiag(D1, D2) + rho v v^T with
    rho = |beta| (the diagonal adjustments were applied on the way down,
    in stedc()). Returns (w (B, m+m2) ascending, q (B, m+m2, m+m2)).

    compact: deflation-aware assembly. The deflated columns of the update
    are unit vectors, so with the alive poles ordered first the update
    gemm runs at the smallest bucket (``_buckets``) that covers the alive
    count, each item at its own, and the other columns pass through.

    mesh: split the O(n2^2) work over its 'tp' ranks (module docstring);
    unused where n2 does not split evenly. Not with compact.

    Sets ``_merge_pair.sweeps`` (secular sweeps run) and, under compact,
    ``_merge_pair.alive`` and ``_merge_pair.bucket`` (one an item)."""
    bsz, m = d1.shape
    n2 = m + d2.shape[1]
    dt = d1.dtype
    dev = d1.device
    eps = torch.finfo(dt).eps
    one = torch.ones((), dtype=dt, device=dev)

    rho = beta.abs()[:, None]
    s = torch.where(beta >= 0, one, -one)[:, None]
    z = torch.cat([s * q1[:, -1, :], q2[:, 0, :]], dim=1)
    d = torch.cat([d1, d2], dim=1)

    # sort poles ascending; remember the permutation for the assembly
    perm = torch.argsort(d, dim=1, stable=True)
    ds = torch.gather(d, 1, perm)
    zs = torch.gather(z, 1, perm)

    # --- deflation by masking (dlaed2's tiny-z test) ---
    big_z = (rho * zs.abs()).amax(dim=1, keepdim=True)
    tol = 8.0 * eps * torch.maximum(ds.abs().amax(dim=1, keepdim=True), big_z)
    alive = rho * zs.abs() > tol
    zs = torch.where(alive, zs, 0.0)
    z2 = zs * zs
    af = alive.to(dt)

    # --- separate surviving poles to a minimum gap ---
    gap_scale = gap_scale[:, None]
    gap_min = 16.0 * eps * gap_scale
    rank = torch.cumsum(af, dim=1) - af
    neg_big = ds.amin(dim=1, keepdim=True) - 2.0 * gap_scale - 1.0
    shifted = torch.where(alive, ds - rank * gap_min, neg_big)
    dsep = torch.cummax(shifted, dim=1).values + rank * gap_min
    dp = torch.where(alive, torch.maximum(ds, dsep), ds)

    # --- per-root search intervals ---
    idx = torch.arange(n2, device=dev).expand(bsz, n2)
    nxt_pos = torch.where(alive, idx, n2)
    nxt_pos = torch.flip(torch.cummin(torch.flip(nxt_pos, (1,)), dim=1).values, (1,))
    nxt_above = torch.cat([nxt_pos[:, 1:], torch.full((bsz, 1), n2, device=dev)], 1)
    zsum = rho * z2.sum(dim=1, keepdim=True)
    ub = dp.amax(dim=1, keepdim=True) + zsum + gap_min
    nxt_d = torch.where(
        nxt_above < n2, torch.gather(dp, 1, nxt_above.clamp_max(n2 - 1)), ub
    )

    # --- secular solve: all roots at once (a rank's block of them under
    # a mesh: rows lo:hi), shifted coordinates ---
    rows = comm.row_range(n2, mesh)
    lo_r, hi_r = (0, n2) if rows is None else rows
    gap_all = nxt_d - dp
    pd = dp[:, None, :] - dp[:, lo_r:hi_r, None]  # pd[b, i, j] = dp[j] - dp[i]
    gap = gap_all[:, lo_r:hi_r]
    le_mask = torch.ones((n2, n2), dtype=torch.bool, device=dev).tril()[lo_r:hi_r]

    def secular_parts(mu, sig_right):
        base = torch.where(sig_right[:, :, None], pd - gap[:, :, None], pd)
        delta = base - mu[:, :, None]
        safe = torch.where(delta == 0, one, delta)
        terms = z2[:, None, :] / safe
        terms2 = terms / safe
        psi = rho * torch.where(le_mask, terms, 0.0).sum(-1)
        phi = rho * torch.where(le_mask, 0.0, terms).sum(-1)
        dpsi = rho * torch.where(le_mask, terms2, 0.0).sum(-1)
        dphi = rho * torch.where(le_mask, 0.0, terms2).sum(-1)
        return psi, phi, dpsi, dphi

    p_mid, q_mid, _, _ = secular_parts(gap / 2, torch.zeros_like(gap, dtype=torch.bool))
    sig_right = 1.0 + p_mid + q_mid < 0
    zero = torch.zeros_like(gap)
    lo = torch.where(sig_right, -gap, zero)
    hi = torch.where(sig_right, zero, gap)
    mu = (lo + hi) / 2
    di = torch.where(sig_right, -gap, zero)  # left pole (mu coordinates)
    dn = torch.where(sig_right, zero, gap)  # right pole
    conv = torch.zeros_like(sig_right)
    # absolute floor eps * gap_min: roots hugging their pole still resolve
    # to full relative precision before the stop fires
    tol_abs = eps * gap_min
    max_it = _secular_iters(dt)
    it = 0
    while it < max_it:
        if it % STOP_EVERY == 0:
            # a deflated lane never meets the bracket test, and its root
            # is thrown away (module docstring)
            done = conv | (hi - lo <= eps * torch.maximum(lo.abs(), hi.abs()) + tol_abs) \
                | ~alive[:, lo_r:hi_r]
            done = done.all()
            if rows is not None:  # every rank's roots
                done = comm.all_reduce(done.to(torch.int32), mesh, op=dist.ReduceOp.MIN,
                                       what="stedc")
            if bool(done):  # one host read every STOP_EVERY sweeps
                break
        it += 1
        psi, phi, dpsi, dphi = secular_parts(mu, sig_right)
        f = 1.0 + psi + phi
        fp = dpsi + dphi
        conv = f.abs() <= 8.0 * eps * (1.0 + psi.abs() + phi.abs())
        lo = torch.where(f < 0, mu, lo)
        hi = torch.where(f >= 0, mu, hi)
        # derivative-matched two-pole rational model (dlaed4 middle way)
        del_i = di - mu
        del_n = dn - mu
        p = dpsi * del_i * del_i
        q = dphi * del_n * del_n
        a = 1.0 + (psi - dpsi * del_i) + (phi - dphi * del_n)
        bq = -a * (di + dn) - p - q
        cq = a * di * dn + p * dn + q * di
        sq = torch.sqrt(torch.clamp_min(bq * bq - 4 * a * cq, 0.0))
        t1 = torch.where(bq >= 0, (-bq - sq) / 2, (-bq + sq) / 2)
        r1 = t1 / torch.where(a == 0, one, a)
        r2 = cq / torch.where(t1 == 0, one, t1)
        in1 = (r1 > lo) & (r1 < hi)
        in2 = (r2 > lo) & (r2 < hi)
        mid1 = in1 & (r1 > di) & (r1 < dn)
        mid2 = in2 & (r2 > di) & (r2 < dn)
        bis = (lo + hi) / 2
        cand = torch.where(
            mid1, r1, torch.where(mid2, r2, torch.where(in1, r1, torch.where(in2, r2, bis)))
        )
        # Newton fallback when the rational model degenerates
        newton = mu - f / torch.where(fp == 0, one, fp)
        cand = torch.where(
            torch.isfinite(cand), cand,
            torch.where((newton > lo) & (newton < hi), newton, bis),
        )
        # converged lanes freeze (the safeguard invariant: a converged lane
        # re-running the step is a no-op; keep it in any new step formula)
        mu = torch.where(conv, mu, cand)
    mu = torch.minimum(torch.maximum(mu, lo), hi)
    # [b, k, i] = lam_k - dp_i for the rows k of this rank's roots
    lam_minus_d = torch.where(sig_right[:, :, None], -(pd - gap[:, :, None]), -pd) + mu[:, :, None]
    if rows is not None:  # every rank's roots
        got = comm.all_gather(torch.stack([mu, sig_right.to(dt)], 1), mesh, axis=-1,
                              what="stedc")
        mu, sig_right = got[:, 0], got[:, 1] > 0.5
    sigma = torch.where(sig_right, nxt_d, dp)
    w = torch.where(alive, sigma + mu, ds)

    # --- Gu/Eisenstat recomputed z via the Loewner formula, for the
    # columns i = lo:hi (all of them without a mesh) ---
    if rows is None:
        lmd_c, pdT = lam_minus_d, -pd  # [b, k, i] = lam_k - dp_i, dp_k - dp_i
    else:
        pd_c = dp[:, None, lo_r:hi_r] - dp[:, :, None]
        lmd_c = torch.where(sig_right[:, :, None], -(pd_c - gap_all[:, :, None]), -pd_c) \
            + mu[:, :, None]
        pdT = -pd_c
    eye = torch.eye(n2, dtype=torch.bool, device=dev)[:, lo_r:hi_r]
    both = alive[:, :, None] & alive[:, None, lo_r:hi_r]
    ratio = torch.where(
        both & ~eye, lmd_c / torch.where(pdT == 0, one, pdT), one
    )
    own = torch.where(alive[:, lo_r:hi_r],
                      torch.diagonal(lmd_c[:, lo_r:hi_r], dim1=1, dim2=2).abs(), one)
    zhat_abs = torch.sqrt(torch.prod(ratio, dim=1).abs() * own)
    zhat = torch.where(alive[:, lo_r:hi_r],
                       torch.where(zs[:, lo_r:hi_r] >= 0, zhat_abs, -zhat_abs), 0.0)
    if rows is not None:
        zhat = comm.all_gather(zhat, mesh, axis=-1, what="stedc")

    # --- eigenvector assembly: the columns k = lo:hi of U ---
    denom_u = -lam_minus_d.transpose(1, 2)  # [b, i, k] = dp_i - lam_k
    safe_u = torch.where(denom_u == 0, one, denom_u)
    u = torch.where(both, zhat[:, :, None] / safe_u, 0.0)
    norms = torch.sqrt((u * u).sum(dim=1))
    u = u / torch.where(norms == 0, one, norms)[:, None, :]
    u = torch.where((~alive[:, None, lo_r:hi_r]) & eye, one, u)

    qcat = torch.zeros((bsz, n2, n2), dtype=dt, device=dev)
    qcat[:, :m, :m] = q1
    qcat[:, m:, m:] = q2
    qp = torch.gather(qcat, 2, perm[:, None, :].expand(bsz, n2, n2))
    order = torch.argsort(w, dim=1, stable=True)
    w = torch.gather(w, 1, order)
    _merge_pair.sweeps = it
    cols = lambda idx: idx[:, None, :].expand(bsz, n2, n2)
    if not compact:
        qnew = qp @ u
        if rows is not None:
            qnew = comm.all_gather(qnew, mesh, axis=-1, what="stedc")
        return w, torch.gather(qnew, 2, cols(order))

    # alive poles first; U restricted to the leading block of the alive
    # count is the whole update (dead rows and columns of U are unit)
    perm2 = torch.argsort((~alive).to(torch.int8), dim=1, stable=True)
    qp_c = torch.gather(qp, 2, cols(perm2))
    u_c = torch.gather(torch.gather(u, 1, perm2[:, :, None].expand(bsz, n2, n2)), 2, cols(perm2))
    sizes = _buckets(n2)
    alive_n = alive.sum(1).tolist()  # the host read of the bucket choice
    bucket = [sizes[sum(a > sz for sz in sizes[:-1])] for a in alive_n]
    for sz in sorted(set(bucket)):
        if bucket.count(sz) == bsz:
            qp_c[:, :, :sz] = qp_c[:, :, :sz] @ u_c[:, :sz, :sz]
        else:
            ix = torch.tensor([k for k, b in enumerate(bucket) if b == sz], device=dev)
            qp_c[ix, :, :sz] = qp_c[ix, :, :sz] @ u_c[ix, :sz, :sz]
    _merge_pair.alive, _merge_pair.bucket = alive_n, bucket
    # column j of the result is column inv2[order[j]] of the alive-first one
    inv2 = torch.argsort(perm2, dim=1)
    return w, torch.gather(qp_c, 2, cols(torch.gather(inv2, 1, order)))


def eigh_or_nan(t):
    """torch.linalg.eigh of symmetric matrices (leading axes a batch), where
    a matrix with a non-finite entry gives NaN eigenpairs instead of an
    error for the whole batch (torch.linalg.eigh raises when one item fails
    to converge; JAX's eigh returns NaN). Such a matrix comes from a B that
    is not positive definite, whose item ``info`` already reports."""
    bad = ~torch.isfinite(t).all(-1).all(-1)
    w, q = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, t))
    nan = torch.full((), float("nan"), dtype=w.dtype, device=w.device)
    return torch.where(bad[..., None], nan, w), torch.where(bad[..., None, None], nan, q)


def _tridiag_dense(d, e):
    return torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)


@highest_precision
def stedc(d, e, leaf=64, leaf_solver=None, mesh=None):
    """All eigenpairs of the symmetric tridiagonal (d, e), on device.

    leaf_solver: None = auto ('xla' for fp32, 'jacobi' for fp64, as in
    the JAX package), 'xla' (torch.linalg.eigh) or 'jacobi'
    (ops/jacobi.py; a leaf of odd size takes dense eigh).

    d (B, n), e (B, n-1) is a batch of problems: the merge tree is static
    in n and ``leaf``, so the problem axis folds into each level's pair
    axis and every level is one merge for the whole batch; the scaling is
    per problem.

    The levels of at most two pairs a problem and the fold merges take the
    compact assembly (JAX's ``compact=mesh is None``); under ``mesh`` they
    take the full assembly and split their work over its 'tp' ranks
    (module docstring), and every rank returns the whole result. After a call,
    ``stedc.sweeps`` lists the secular sweeps of each merge and
    ``stedc.compact`` (n2, alive counts, buckets) of each compact merge.
    Under ``utils/tracing.py`` the solve is the range ``stedc`` and the
    batched leaf eigensolve the range ``stedc_leaves`` inside it.
    """
    batched = d.dim() == 2
    if not batched:
        d, e = d[None], e[None]
    bsz, n = d.shape
    dt = d.dtype
    dev = d.device
    if leaf_solver is None:
        leaf_solver = "xla" if dt == torch.float32 else "jacobi"
    if leaf_solver not in ("xla", "jacobi"):
        raise ValueError(f"unknown leaf_solver {leaf_solver!r}")

    def leaf_eigh(tb):
        if leaf_solver == "jacobi" and tb.shape[-1] % 2 == 0:
            return jacobi_eigh(tb)
        return eigh_or_nan(tb)

    def done(w, q):
        return (w, q) if batched else (w[0], q[0])

    def merge(*args, top):
        # JAX's top merges: the compact assembly without a mesh, the full
        # one split over the mesh with one
        compact = top and mesh is None
        out = _merge_pair(*args, compact=compact, mesh=mesh if top else None)
        stedc.sweeps.append(_merge_pair.sweeps)
        if compact:
            stedc.compact.append((out[0].shape[1], _merge_pair.alive, _merge_pair.bucket))
        return out

    stedc.sweeps, stedc.compact = [], []

    if n <= 2 or n <= leaf:
        return done(*leaf_eigh(_tridiag_dense(d, e)))

    with trace_range("stedc"):
        # scale each problem to unit norm-ish (dstedc scales by orgnrm)
        orgnrm = torch.maximum(d.abs().amax(-1), e.abs().amax(-1))
        scale = torch.where(orgnrm > 0, orgnrm, torch.ones_like(orgnrm))[:, None]
        d = d / scale
        e = e / scale

        # pad to a whole number of leaves with distinct decoupled values
        # just above the scaled spectrum (Gershgorin of T/scale <= 3)
        nblk = -(-n // leaf)
        npad = leaf * nblk
        pad = npad - n
        pad_vals = 4.0 + torch.arange(pad, dtype=dt, device=dev) * (1.0 / 1024.0)
        dp_full = torch.cat([d, pad_vals.expand(bsz, pad)], 1)
        e_full = torch.cat([e, torch.zeros((bsz, pad), dtype=dt, device=dev)], 1)
        if pad > 0:
            e_full[:, n - 1] = 0.0  # decouple the padding

        # way-down diagonal adjustments at every merge boundary
        bidx = torch.arange(1, nblk, device=dev) * leaf
        babs = e_full[:, bidx - 1].abs()
        dp_adj = dp_full.clone()
        dp_adj[:, bidx - 1] -= babs
        dp_adj[:, bidx] -= babs

        # leaves: batched dense eigh of leaf-sized tridiagonal blocks
        db = dp_adj.reshape(bsz, nblk, leaf)
        e_in = torch.cat([e_full[:, : npad - 1], torch.zeros((bsz, 1), dtype=dt, device=dev)], 1)
        e_in = e_in.reshape(bsz, nblk, leaf).clone()
        e_in[..., -1] = 0.0  # drop the cross-block boundary e
        tb = torch.diag_embed(db) + torch.diag_embed(e_in[..., :-1], 1) + torch.diag_embed(
            e_in[..., :-1], -1
        )
        with trace_range("stedc_leaves"):
            wb, qb = leaf_eigh(tb)

        gap_scale = torch.clamp_min(dp_full.abs().amax(-1), 1.0)

        def tree(wb_c, qb_c, start_el, nblk_c):
            """Power-of-two merge tree over nblk_c leaves of every problem
            whose first element sits at global index start_el; a level
            merges the pairs of all problems at once, compactly once it
            has at most two pairs a problem (JAX's unbatched top merges)."""
            m = leaf
            sz = nblk_c * leaf
            while m < sz:
                pairs = sz // (2 * m)
                w2 = wb_c.reshape(bsz * pairs, 2, m)
                q2 = qb_c.reshape(bsz * pairs, 2, m, m)
                cols = start_el + (2 * torch.arange(pairs, device=dev) + 1) * m - 1
                betas = e_full[:, cols].reshape(bsz * pairs)
                gs = gap_scale[:, None].expand(bsz, pairs).reshape(bsz * pairs)
                wb_c, qb_c = merge(w2[:, 0], q2[:, 0], w2[:, 1], q2[:, 1], betas, gs,
                                   top=pairs <= 2)
                m *= 2
            return wb_c.reshape(bsz, sz), qb_c.reshape(bsz, sz, sz)

        # binary decomposition of the block count, largest group first;
        # the groups fold left to right through unequal-size merges
        acc_w = acc_q = None
        start = 0
        for bit in reversed(range(nblk.bit_length())):
            size = 1 << bit
            if not nblk & size:
                continue
            wg, qg = tree(wb[:, start : start + size], qb[:, start : start + size],
                          start * leaf, size)
            if acc_w is None:
                acc_w, acc_q = wg, qg
            else:
                beta = e_full[:, start * leaf - 1]
                acc_w, acc_q = merge(acc_w, acc_q, wg, qg, beta, gap_scale, top=True)
            start += size

        # padding deflates to eigenvalues >= 4 > Gershgorin(T/scale) <= 3,
        # so after the sorted merge the real pairs come first
        return done(acc_w[:, :n] * scale, acc_q[:, :n, :n])
