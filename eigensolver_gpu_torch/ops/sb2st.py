"""Stage 2 of the two-stage tridiagonalization: symmetric band ->
tridiagonal by wavefront-batched bulge chasing, and the blocked replay of
the chase reflectors onto eigenvector columns (twin of
eigensolver_gpu_tpu/ops/sb2st.py).

Storage contracts, the JAX package's to the letter:

* the band is LAPACK-style lower band storage ``B[j, d] = A[j+d, j]`` with
  2b diagonals (the chase's largest intermediate bandwidth is 2b-1);
* chase schedule: sweep ``v`` eliminates column ``v``; its chase step ``k``
  applies a length-<=b reflector at rows ``r0 = v+1+k*b``. On the wavefront
  ``t = 3v + k`` all active (v, k) touch band strips ``3b-1`` rows apart,
  so a timestep is one batch of independent windows;
* reflector (v, k) is stored at ``vt[3v+k, k//3]``; ``vt`` is
  ``(t3, s_slots, b)`` and ``taut`` ``(t3, s_slots)`` with
  ``t3 = 3*ceil(t_total/3)``, ``t_total = 3(n-3)+1``,
  ``s_slots = ((n-3)//b)//3 + 1``; inactive slots carry ``tau = 0``;
* replay: groups of ``g`` sweeps taken descending, chase windows ascending,
  each window one compact-WY block with ``T^-1 = striu(V^T V) + diag(1/tau)``,
  scheduled in waves ``tau = 2(G-1-j) + k`` whose windows are disjoint.

``bulge_chase`` is the plain version of kernel K7 (ops/chase.py) and
``apply_q2(tsolve='qform')`` of kernel K9 (ops/replay.py): they serve CPU
tensors and ``SolverConfig(mosaic_kernels=False)``. The JAX module builds
its windows with pad/flatten/reshape tricks because gathers are slow on a
TPU; here plain index tensors do the same moves.
"""

from __future__ import annotations

import numpy as np
import torch

from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def dense_to_band(a, b):
    """Lower band storage with 2b diagonals: ``B[j, d] = A[j+d, j]`` (zero
    where j+d >= n). ``a`` symmetric (n, n); returns (n, 2b)."""
    n = a.shape[0]
    cols = torch.arange(n, device=a.device)[:, None]
    rows = cols + torch.arange(2 * b, device=a.device)[None, :]  # j + d
    vals = a[rows.clamp_max(n - 1), cols]
    return torch.where(rows < n, vals, torch.zeros_like(vals))


def band_to_dense(band, b):
    """Inverse of dense_to_band (symmetric reconstruction)."""
    n = band.shape[0]
    out = torch.zeros((n, n), dtype=band.dtype, device=band.device)
    for d in range(min(2 * b, n)):
        out += torch.diag(band[: n - d, d], -d)
    return out + torch.tril(out, -1).T


def _larfg_vec(x):
    """Batched real Householder: zero x[:, 1:], pivot x[:, 0].

    Returns (v, tau, beta) with v[:, 0] = 1 (or 0 for trivial columns),
    H = I - tau v v^T, H x = beta e1. LAPACK dlarfg conventions,
    branch-free."""
    alpha = x[:, 0]
    xnormsq = torch.sum(x[:, 1:] * x[:, 1:], dim=1)
    norm = torch.sqrt(alpha * alpha + xnormsq)
    beta = torch.where(alpha >= 0, -norm, norm)
    trivial = xnormsq == 0
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    tau = torch.where(trivial, zero, (beta - alpha) / torch.where(trivial, one, beta))
    v = x / torch.where(trivial, one, alpha - beta)[:, None]
    v[:, 0] = torch.where(trivial, zero, one)
    return v, tau, torch.where(trivial, alpha, beta)


def chase_dims(n, b):
    """(s_slots, t_total, t3) of the chase's reflector store."""
    s_slots = max((n - 3) // b, 0) // 3 + 1
    t_total = 3 * (n - 3) + 1 if n > 3 else 1
    return s_slots, t_total, 3 * ((t_total + 2) // 3)


@highest_precision
def bulge_chase(band, b):
    """Chase a symmetric band matrix (lower storage, 2b diagonals, see
    dense_to_band) to tridiagonal. Returns (d, e, vt, taut): the
    tridiagonal, plus the chase reflectors in timestep storage for
    apply_q2. Requires n >= 3 and b >= 2."""
    n = band.shape[0]
    dtype, dev = band.dtype, band.device
    w = 2 * b
    if band.shape[1] != w:
        raise ValueError(f"band must have 2b={w} diagonals, got {band.shape[1]}")
    s_slots, t_total, t3 = chase_dims(n, b)
    stride = 3 * b - 1

    # padded band: front pad 2b, back pad covers the largest strip read
    pad_f = 2 * b
    band_p = torch.zeros((n + pad_f + 2 * b + s_slots * stride + w, w), dtype=dtype, device=dev)
    band_p[pad_f : pad_f + n] = band
    vt = torch.zeros((t3, s_slots, b), dtype=dtype, device=dev)
    taut = torch.zeros((t3, s_slots), dtype=dtype, device=dev)

    svec = torch.arange(s_slots, device=dev)
    # strip rows of slot s, relative to the timestep's start row
    rel_rows = (svec * stride)[:, None] + torch.arange(w, device=dev)[None, :]
    # window W[p, q] = strip[q, p-q] for 0 <= p-q < 2b (lower trapezoid)
    p_i = torch.arange(3 * b, device=dev)[:, None]
    q_i = torch.arange(w, device=dev)[None, :]
    in_band = (p_i >= q_i) & (p_i - q_i < w)
    d_i = (p_i - q_i).clamp(0, w - 1)
    # and back: strip[q, d] = W[q+d, q] where q+d < 3b, else unchanged
    qq = torch.arange(w, device=dev)[:, None]
    dd = torch.arange(w, device=dev)[None, :]
    in_win = qq + dd < 3 * b
    pq = (qq + dd).clamp_max(3 * b - 1)

    with trace_range("bulge_chase"):
        for t in range(t_total):
            vmax, k0 = divmod(t, 3)
            v_s = vmax - svec
            k_s = k0 + 3 * svec
            r0_s = v_s + 1 + k_s * b
            active = (v_s >= 0) & (v_s <= n - 3) & (r0_s <= n - 2)

            rows = (vmax + 1 + k0 * b - b + pad_f) + rel_rows  # (S, 2b)
            strip = band_p[rows]  # (S, 2b, 2b)
            zero = torch.zeros((), dtype=dtype, device=dev)
            wlow = torch.where(in_band, strip[:, q_i, d_i], zero)
            # dense symmetric 3b x 3b windows (the [2b:, 2b:] corner unused)
            wd = torch.zeros((s_slots, 3 * b, 3 * b), dtype=dtype, device=dev)
            wd[:, :, :w] = wlow
            wd = wd + wd.transpose(1, 2) - torch.diag_embed(torch.diagonal(wd, dim1=1, dim2=2))

            # reflector source: rows [r0, r0+b) of column r0-1 (sweep start,
            # k == 0) or r0-b (in-chase); window rows [b, 2b)
            x = torch.where((k_s == 0)[:, None], wd[:, b:w, b - 1], wd[:, b:w, 0])
            v, tau, _ = _larfg_vec(x)
            tau = torch.where(active, tau, torch.zeros_like(tau))

            # H A H on the window, H = I - tau v v^T on rows/cols [b, 2b)
            rws = wd[:, b:w, :]
            vtr = torch.einsum("sp,spq->sq", v, rws)
            wd[:, b:w, :] = rws - tau[:, None, None] * v[:, :, None] * vtr[:, None, :]
            cols = wd[:, :, b:w]
            cv = torch.einsum("spq,sq->sp", cols, v)
            wd[:, :, b:w] = cols - tau[:, None, None] * cv[:, :, None] * v[:, None, :]

            band_p[rows] = torch.where(in_win, wd[:, pq, qq], strip)
            vt[t] = v
            taut[t] = tau
    out = band_p[pad_f : pad_f + n]
    return out[:, 0].clone(), out[: n - 1, 1].clone(), vt, taut


def repack_sweep_major(vt, taut, b, n):
    """Repack vt[t, s] -> V2[k, v] sweep-major storage.

    Reflector (v, k) of the chase lives at t = 3v+k, s = k//3; for
    k = 3s+c, V2[3s+c, v] = vt[3(v+s)+c, s] (zero past the store). Returns
    (v2 (3*s_slots, nv, b), t2 (3*s_slots, nv)) with nv = max(n-2, 1)
    (sweeps v in [0, n-3])."""
    t3, s_slots, _ = vt.shape
    dev = vt.device
    nv = max(n - 2, 1)
    k = torch.arange(3 * s_slots, device=dev)[:, None]
    s, c = k // 3, k % 3
    t = 3 * (torch.arange(nv, device=dev)[None, :] + s) + c  # (3S, nv)
    ok = t < t3
    t = t.clamp_max(t3 - 1)
    s = s.expand_as(t)
    v2 = torch.where(ok[:, :, None], vt[t, s], torch.zeros((), dtype=vt.dtype, device=dev))
    t2 = torch.where(ok, taut[t, s], torch.zeros((), dtype=taut.dtype, device=dev))
    return v2, t2


def _padded_pack(vt, taut, b, n, g, n_groups, kmax):
    """Sweep-major reflector pack, flattened and padded so that an
    out-of-range (k, sweep) index lands in zeros: k rows up to kp-1 (the
    last one all zero), sweeps up to nvp = n_groups*g + g. Returns
    (v2f (kp*nvp, b), t2f (kp*nvp,), nvp, kp)."""
    v2, t2 = repack_sweep_major(vt, taut, b, n)
    kcap, nv = t2.shape
    nvp = n_groups * g + g
    kp = max(kmax + 2, kcap)
    v2p = torch.zeros((kp, nvp, b), dtype=vt.dtype, device=vt.device)
    t2p = torch.zeros((kp, nvp), dtype=taut.dtype, device=vt.device)
    v2p[:kcap, :nv] = v2
    t2p[:kcap, :nv] = t2
    return v2p.reshape(kp * nvp, b), t2p.reshape(kp * nvp), nvp, kp


def _staircase(vblk, taus, g, b):
    """Staircase embedding of window reflectors: vblk (..., g, b), taus
    (..., g) -> vw (..., l_win, g) with vw[r, s] = vblk[s, r-s] for
    0 <= r-s < b (else 0), columns with tau == 0 zeroed."""
    l_win = b + g - 1
    dev = vblk.device
    r = torch.arange(l_win, device=dev)[:, None]
    s = torch.arange(g, device=dev)[None, :]
    off = r - s
    ok = (off >= 0) & (off < b)
    vw = vblk[..., s.expand(l_win, g), off.clamp(0, b - 1)]
    keep = ok & (taus != 0)[..., None, :]
    return torch.where(keep, vw, torch.zeros((), dtype=vblk.dtype, device=dev))


def _triu_inv(t):
    """Batched inverse of upper-triangular ``t`` (the JAX package block-
    doubles it because XLA's batched triangular solve is slow; here the
    library's solve against the identity does)."""
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device).expand_as(t)
    return torch.linalg.solve_triangular(t, eye, upper=True)


def _tinv(vw, taus):
    """T^-1 = striu(V^T V) + diag(1/tau) of staircase blocks (tau == 0
    columns are zero in vw and take a unit diagonal)."""
    tsafe = torch.where(taus == 0, torch.ones_like(taus), taus)
    return torch.triu(vw.transpose(-1, -2) @ vw, 1) + torch.diag_embed(1.0 / tsafe)


def window_q(vw, taus):
    """Window orthogonals Q = I - V T V^T of staircase blocks: vw
    (..., l_win, g), taus (..., g) -> (..., l_win, l_win)."""
    eye = torch.eye(vw.shape[-2], dtype=vw.dtype, device=vw.device)
    return eye - vw @ (_triu_inv(_tinv(vw, taus)) @ vw.transpose(-1, -2))


def _wave_plan(n, b, g, slot_round=1):
    """Static wave schedule of the replay (see apply_q2), the one place
    that keeps it: per wave (numpy arrays over the waves) its parity
    ``par``, first group ``c0``, first slot read ``u_lo`` and row base
    ``base``; the front pad ``fy`` and height ``rows_p`` of the padded y in
    which every slot's rows exist (the clamped bases dip below row 0 and the
    top windows reach past n). ``n_slots`` is the active slot count rounded
    up to a multiple of ``slot_round`` (the replay kernels' window store
    keeps the JAX multiple of 4); the clamp of ``u_lo`` depends on it."""
    kmax = max((n - 3) // b, 0)
    l_win = b + g - 1
    n_groups = -(-max(n - 2, 1) // g)
    n_u = kmax // 2 + 1
    # windows that meet rows [0, n) number at most cdiv(n-2, g+2b)+1
    n_act = min(n_u, -(-(n - 2) // (g + 2 * b)) + 1)
    n_slots = -(-n_act // slot_round) * slot_round
    spacing = g + 2 * b
    n_waves = 2 * (n_groups - 1) + kmax + 1
    waves = np.arange(n_waves)
    par = waves % 2
    c0 = n_groups - 1 - (waves - par) // 2
    u_lo = np.minimum(np.maximum(0, -c0), max(n_u - n_slots, 0))
    base = (c0 + u_lo) * g + 1 + par * b + 2 * b * u_lo
    fy = max(0, -int(base.min())) + 8
    rows_p = fy + max(int(base.max()) + n_slots * spacing + l_win, n) + 8
    return dict(kmax=kmax, l_win=l_win, n_groups=n_groups, n_u=n_u, n_act=n_act,
                n_slots=n_slots, n_waves=n_waves, spacing=spacing, par=par, c0=c0,
                u_lo=u_lo, base=base, fy=fy, rows_p=rows_p)


def _wave_gather(plan, n, b, g, nvp, kp):
    """Slot i of wave tau -> window (j, k) -> the rows of the (kp, nvp, b)-
    padded sweep-major reflector pack that hold its g reflectors, flattened.
    Returns numpy (valid (n_waves, n_slots) bool, flat_idx (n_waves,
    n_slots, g)); a slot outside the schedule indexes zero padding (sweep
    n_groups*g.., k row kp-1). csrc/replay.cu and csrc/replay_planar.cu
    derive the same (j, k) per block."""
    n_groups = plan["n_groups"]
    u = plan["u_lo"][:, None] + np.arange(plan["n_slots"])[None, :]
    jarr = plan["c0"][:, None] + u
    karr = plan["par"][:, None] + 2 * u
    valid = ((jarr >= 0) & (jarr < n_groups) & (karr <= plan["kmax"])
             & (jarr * g + karr * b <= n - 3))
    jj = np.where(valid, jarr, n_groups)
    kk = np.where(valid, karr, kp - 1)
    return valid, kk[:, :, None] * nvp + jj[:, :, None] * g + np.arange(g)


def _wave_indices(plan, n, b, g, nvp, kp, dev):
    """Every wave's gathers, as tensors on ``dev``: ``ridx`` (n_waves,
    n_slots, g) from _wave_gather, and ``rows`` (n_waves, n_slots, l_win),
    each slot's rows of the padded y."""
    _, ridx = _wave_gather(plan, n, b, g, nvp, kp)
    rows = (plan["fy"] + plan["base"][:, None, None]
            + (np.arange(plan["n_slots"]) * plan["spacing"])[None, :, None]
            + np.arange(plan["l_win"])[None, None, :])
    return torch.from_numpy(ridx).to(dev), torch.from_numpy(rows).to(dev)


@highest_precision
def apply_q2(vt, taut, y, n, b, g=None, tsolve="qform"):
    """y <- Q2 y where Q2 is the accumulated bulge-chase transform
    (band = Q2^T A_band Q2). y is (n, m); reflectors from bulge_chase.

    Wavefront-batched blocked replay: reflectors are grouped into
    compact-WY windows of ``g`` consecutive sweeps per chase position
    (window (j, k) covers sweeps [jg, jg+g) at chase hop k, rows
    jg+1+kb .. +b+g-1). The sequential order (groups descending, k
    ascending) becomes the wave schedule tau = 2(G-1-j) + k; windows of
    one wave start g+2b rows apart, past the window length b+g-1, so
    they are disjoint for every g >= 1, b >= 2 (the JAX module's
    docstring has the proof). Slot u of a wave holds window
    (j = c0+u, k = par+2u); out-of-range slots are identity windows.

    tsolve: 'qform' applies each window as one (l_win x l_win) product
    with its explicit orthogonal; 'inv' and 'solve' apply the WY factors
    with the inverted, respectively solved, T^-1."""
    if g is None:
        g = b
    if tsolve not in ("qform", "inv", "solve"):
        raise ValueError(f"unknown tsolve {tsolve!r}")
    plan = _wave_plan(n, b, g)
    with trace_range("apply_q2_repack"):
        v2f, t2f, nvp, kp = _padded_pack(vt, taut, b, n, g, plan["n_groups"], plan["kmax"])
    fy = plan["fy"]
    y_p = torch.zeros((plan["rows_p"], y.shape[1]), dtype=y.dtype, device=y.device)
    y_p[fy : fy + n] = y

    with trace_range("apply_q2"):
        ridx_all, rows_all = _wave_indices(plan, n, b, g, nvp, kp, y.device)
        for ridx, rows in zip(ridx_all, rows_all):
            taus = t2f[ridx]
            vw = _staircase(v2f[ridx], taus, g, b)  # (n_slots, l_win, g)
            yw = y_p[rows]  # (n_slots, l_win, m)
            if tsolve == "qform":
                yw = window_q(vw, taus) @ yw
            else:
                tinv = _tinv(vw, taus)
                u_m = vw.transpose(1, 2) @ yw
                if tsolve == "inv":
                    x = _triu_inv(tinv) @ u_m
                else:
                    x = torch.linalg.solve_triangular(tinv, u_m, upper=True)
                yw = yw - vw @ x
            y_p[rows] = yw
    return y_p[fy : fy + n].clone()
