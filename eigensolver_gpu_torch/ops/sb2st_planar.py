"""Planar complex stage 2 of the two-stage tridiagonalization: Hermitian
band -> real tridiagonal by wavefront-batched bulge chasing, the phase
normalisation of the complex subdiagonal, and the planar blocked replay
(twin of eigensolver_gpu_tpu/ops/sb2st_planar.py).

Differences from the real chase (ops/sb2st.py), the JAX package's to the
letter:

* reflectors are complex (planar zlarfg: real beta, complex tau and v).
  zlarfg annihilates through ``H^H`` (``H^H x = beta e1``), so the
  similarity is ``A <- H^H A H`` with ``H = I - tau v v^H``: rows take
  ``conj(tau)``, columns ``tau``, and Q2 accumulates as ``H_1 H_2 .. H_N``;
* the chased tridiagonal has a complex subdiagonal; ``phase_normalize``
  gives the diagonal unitary D with ``D^H T D`` real. Eigenvectors of the
  band matrix are ``Q2 (D z)`` for z of the real tridiagonal;
* the compact-WY identity of a replay window is
  ``T^-1 = striu(V^H V) + diag(1/tau)`` with complex ``1/tau``; a dead
  reflector (``tau == 0``) takes a unit diagonal and a zero column.

Band storage: one (n, 2b) plane per component, ``B[j, d] = A[j+d, j]``
(ops/sb2st.dense_to_band): the LOWER triangle, so the imaginary plane
holds ``-Im(upper)``. The reflector store has the layout of ops/sb2st.py,
one pair of planes each for ``vt`` and ``taut``.

``bulge_chase_planar`` is the plain version of kernel K8 (ops/chase.py)
and ``apply_q2_planar`` of kernel K10 (ops/replay.py): they serve CPU
tensors and ``SolverConfig(mosaic_kernels=False)``.
"""

from __future__ import annotations

import torch

from eigensolver_gpu_torch.ops.sb2st import (
    _padded_pack,
    _staircase,
    _wave_indices,
    _wave_plan,
    chase_dims,
)
from eigensolver_gpu_torch.ops.sytrd_planar import _larfg_planar
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range


def _larfg_vec_planar(xr, xi):
    """Batched planar zlarfg: zero x[:, 1:], pivot x[:, 0] -> REAL beta.

    Returns (vr, vi, tau_r, tau_i, beta) with v[:, 0] = 1 (0 for trivial
    columns: zero tail AND real pivot). LAPACK zlarfg conventions."""
    xnormsq = torch.sum(xr[:, 1:] * xr[:, 1:] + xi[:, 1:] * xi[:, 1:], dim=1)
    beta, tau_r, tau_i, sc_r, sc_i = _larfg_planar(xr[:, 0], xi[:, 0], xnormsq)
    vr = xr * sc_r[:, None] - xi * sc_i[:, None]
    vi = xr * sc_i[:, None] + xi * sc_r[:, None]
    trivial = (tau_r == 0) & (tau_i == 0)
    vr[:, 0] = torch.where(trivial, torch.zeros_like(beta), torch.ones_like(beta))
    vi[:, 0] = 0.0
    return vr, vi, tau_r, tau_i, beta


def _pbmm(x, y):
    """Batched planar product, four real products (no Karatsuba: the
    window algebra is small and keeps each plane's own rounding)."""
    return x[0] @ y[0] - x[1] @ y[1], x[0] @ y[1] + x[1] @ y[0]


@highest_precision
def bulge_chase_planar(band_r, band_i, b):
    """Chase a Hermitian planar band (lower storage, 2b diagonals) to a
    complex tridiagonal. Returns (d, (e_r, e_i), (vt_r, vt_i),
    (taut_r, taut_i)): real diagonal, complex subdiagonal, and the chase
    reflectors in timestep storage for apply_q2_planar. The window is
    rebuilt Hermitian at every step, so the imaginary part of its diagonal
    is read as zero. Requires n >= 3 and b >= 2."""
    n = band_r.shape[0]
    dtype, dev = band_r.dtype, band_r.device
    w = 2 * b
    if band_r.shape[1] != w or band_i.shape != band_r.shape:
        raise ValueError(f"both band planes must be (n, 2b={w}), got "
                         f"{tuple(band_r.shape)} and {tuple(band_i.shape)}")
    s_slots, t_total, t3 = chase_dims(n, b)
    stride = 3 * b - 1

    pad_f = 2 * b
    shape_p = (n + pad_f + 2 * b + s_slots * stride + w, w)
    bp_r = torch.zeros(shape_p, dtype=dtype, device=dev)
    bp_i = torch.zeros(shape_p, dtype=dtype, device=dev)
    bp_r[pad_f : pad_f + n] = band_r
    bp_i[pad_f : pad_f + n] = band_i
    vt_r = torch.zeros((t3, s_slots, b), dtype=dtype, device=dev)
    vt_i = torch.zeros_like(vt_r)
    tt_r = torch.zeros((t3, s_slots), dtype=dtype, device=dev)
    tt_i = torch.zeros_like(tt_r)

    # the index tensors of ops/sb2st.bulge_chase
    svec = torch.arange(s_slots, device=dev)
    rel_rows = (svec * stride)[:, None] + torch.arange(w, device=dev)[None, :]
    p_i = torch.arange(3 * b, device=dev)[:, None]
    q_i = torch.arange(w, device=dev)[None, :]
    in_band = (p_i >= q_i) & (p_i - q_i < w)
    d_i = (p_i - q_i).clamp(0, w - 1)
    qq = torch.arange(w, device=dev)[:, None]
    dd = torch.arange(w, device=dev)[None, :]
    in_win = qq + dd < 3 * b
    pq = (qq + dd).clamp_max(3 * b - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)

    with trace_range("bulge_chase_planar"):
        for t in range(t_total):
            vmax, k0 = divmod(t, 3)
            v_s = vmax - svec
            k_s = k0 + 3 * svec
            r0_s = v_s + 1 + k_s * b
            active = (v_s >= 0) & (v_s <= n - 3) & (r0_s <= n - 2)

            rows = (vmax + 1 + k0 * b - b + pad_f) + rel_rows  # (S, 2b)
            strip_r, strip_i = bp_r[rows], bp_i[rows]
            # dense Hermitian 3b x 3b windows from the lower trapezoid
            wd_r = torch.zeros((s_slots, 3 * b, 3 * b), dtype=dtype, device=dev)
            wd_i = torch.zeros_like(wd_r)
            wd_r[:, :, :w] = torch.where(in_band, strip_r[:, q_i, d_i], zero)
            wd_i[:, :, :w] = torch.where(in_band, strip_i[:, q_i, d_i], zero)
            wd_r = wd_r + wd_r.transpose(1, 2) - torch.diag_embed(
                torch.diagonal(wd_r, dim1=1, dim2=2))
            wd_i = wd_i - wd_i.transpose(1, 2)

            src = (k_s == 0)[:, None]
            x_r = torch.where(src, wd_r[:, b:w, b - 1], wd_r[:, b:w, 0])
            x_i = torch.where(src, wd_i[:, b:w, b - 1], wd_i[:, b:w, 0])
            v_r, v_i, tau_r, tau_i, _ = _larfg_vec_planar(x_r, x_i)
            tau_r = torch.where(active, tau_r, zero)
            tau_i = torch.where(active, tau_i, zero)
            tr, ti = tau_r[:, None], tau_i[:, None]

            # left: rows <- H^H rows = rows - v (conj(tau) (v^H rows))
            rows_r, rows_i = wd_r[:, b:w, :], wd_i[:, b:w, :]
            u_r = torch.einsum("sp,spq->sq", v_r, rows_r) + torch.einsum("sp,spq->sq", v_i, rows_i)
            u_i = torch.einsum("sp,spq->sq", v_r, rows_i) - torch.einsum("sp,spq->sq", v_i, rows_r)
            tu_r = tr * u_r + ti * u_i
            tu_i = tr * u_i - ti * u_r
            wd_r[:, b:w, :] = rows_r - (v_r[:, :, None] * tu_r[:, None, :]
                                        - v_i[:, :, None] * tu_i[:, None, :])
            wd_i[:, b:w, :] = rows_i - (v_r[:, :, None] * tu_i[:, None, :]
                                        + v_i[:, :, None] * tu_r[:, None, :])

            # right: cols <- cols H = cols - (tau (cols v)) v^H
            cols_r, cols_i = wd_r[:, :, b:w], wd_i[:, :, b:w]
            c_r = torch.einsum("spq,sq->sp", cols_r, v_r) - torch.einsum("spq,sq->sp", cols_i, v_i)
            c_i = torch.einsum("spq,sq->sp", cols_r, v_i) + torch.einsum("spq,sq->sp", cols_i, v_r)
            tc_r = tr * c_r - ti * c_i
            tc_i = tr * c_i + ti * c_r
            wd_r[:, :, b:w] = cols_r - (tc_r[:, :, None] * v_r[:, None, :]
                                        + tc_i[:, :, None] * v_i[:, None, :])
            wd_i[:, :, b:w] = cols_i - (tc_i[:, :, None] * v_r[:, None, :]
                                        - tc_r[:, :, None] * v_i[:, None, :])

            bp_r[rows] = torch.where(in_win, wd_r[:, pq, qq], strip_r)
            bp_i[rows] = torch.where(in_win, wd_i[:, pq, qq], strip_i)
            vt_r[t], vt_i[t] = v_r, v_i
            tt_r[t], tt_i[t] = tau_r, tau_i
    out_r = bp_r[pad_f : pad_f + n]
    out_i = bp_i[pad_f : pad_f + n]
    e = (out_r[: n - 1, 1].clone(), out_i[: n - 1, 1].clone())
    return out_r[:, 0].clone(), e, (vt_r, vt_i), (tt_r, tt_i)


def phase_normalize(e_r, e_i):
    """Diagonal unitary D with D^H T D real for the complex tridiagonal
    (d real, subdiagonal e): returns ((p_r, p_i), e_abs) with
    D = diag(p_0..p_{n-1}), p_0 = 1, p_{j+1} = p_j * e_j / |e_j|
    (p_{j+1} = p_j for |e_j| = 0). Then (D^H T D)_{j+1,j} = |e_j|.

    A sequential cumulative product of unit complex numbers (the JAX
    package takes a log-depth scan; no transcendentals in either). The
    fp32 product drifts off unit modulus by about sqrt(n) * eps, which
    would scale eigenvector norms, so it is renormalised."""
    mag = torch.sqrt(e_r * e_r + e_i * e_i)
    dead = mag == 0
    safe = torch.where(dead, torch.ones_like(mag), mag)
    ph_r = torch.where(dead, torch.ones_like(mag), e_r / safe)
    ph_i = torch.where(dead, torch.zeros_like(mag), e_i / safe)
    one = torch.ones((1,), dtype=e_r.dtype, device=e_r.device)
    seq = torch.complex(torch.cat([one, ph_r]), torch.cat([torch.zeros_like(one), ph_i]))
    p = torch.cumprod(seq, dim=0)
    pm = p.abs()
    pm = torch.where(pm == 0, torch.ones_like(pm), pm)
    return (p.real / pm, p.imag / pm), mag


def _ptriu_inv(tr, ti):
    """Batched inverse of planar upper-triangular blocks (..., k, k). The
    JAX package block-doubles it in planar arithmetic because XLA's batched
    triangular solve is slow and its TPU stack has no complex type; an
    eager port of that recursion costs about 2 000 small launches per batch
    of windows and left the card idle (1.1 s of a 2.4 s solve at n = 4096
    on an H100), so here the library's complex triangular solve against the
    identity does, as ops/sb2st._triu_inv does for the real replay."""
    t = torch.complex(tr, ti)
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device).expand_as(t)
    inv = torch.linalg.solve_triangular(t, eye, upper=True)
    return inv.real, inv.imag


def window_q_planar(vw, taus):
    """Window unitaries Q = I - V T V^H of planar staircase blocks:
    vw = (vw_r, vw_i) (..., l_win, g) with dead columns zeroed, taus =
    (tau_r, tau_i) (..., g) -> (q_r, q_i) (..., l_win, l_win), with
    T^-1 = striu(V^H V) + diag(1/tau) and a unit diagonal for tau == 0."""
    ta_r, ta_i = taus
    live = (ta_r != 0) | (ta_i != 0)
    one, zero = torch.ones_like(ta_r), torch.zeros_like(ta_r)
    safe = torch.where(live, ta_r * ta_r + ta_i * ta_i, one)
    inv_r = torch.where(live, ta_r / safe, one)  # Re(1/tau)
    inv_i = torch.where(live, -ta_i / safe, zero)
    vh = (vw[0].transpose(-1, -2), -vw[1].transpose(-1, -2))
    g_r, g_i = _pbmm(vh, vw)
    t_inv = _ptriu_inv(torch.triu(g_r, 1) + torch.diag_embed(inv_r),
                       torch.triu(g_i, 1) + torch.diag_embed(inv_i))
    q_r, q_i = _pbmm(vw, _pbmm(t_inv, vh))
    eye = torch.eye(vw[0].shape[-2], dtype=q_r.dtype, device=q_r.device)
    return eye - q_r, -q_i


def _planar_staircase(v2f, t2f, ridx, g, b):
    """Gather one batch of windows from the padded planar pack: returns
    (vw, taus) for window_q_planar, dead columns zeroed in both planes."""
    taus = (t2f[0][ridx], t2f[1][ridx])
    live = ((taus[0] != 0) | (taus[1] != 0)).to(taus[0].dtype)
    return (_staircase(v2f[0][ridx], live, g, b), _staircase(v2f[1][ridx], live, g, b)), taus


def _padded_pack_planar(vt, taut, b, n, g, n_groups, kmax):
    """ops/sb2st._padded_pack of both planes: ((v2f_r, v2f_i),
    (t2f_r, t2f_i), nvp, kp)."""
    v2f_r, t2f_r, nvp, kp = _padded_pack(vt[0], taut[0], b, n, g, n_groups, kmax)
    v2f_i, t2f_i, _, _ = _padded_pack(vt[1], taut[1], b, n, g, n_groups, kmax)
    return (v2f_r, v2f_i), (t2f_r, t2f_i), nvp, kp


@highest_precision
def apply_q2_planar(vt, taut, y, n, b, g=None):
    """Planar y <- Q2 y: the complex twin of ops/sb2st.apply_q2 with
    ``tsolve='qform'`` (same wave schedule; its validity does not depend on
    the type). vt = (vt_r, vt_i), taut = (taut_r, taut_i) from
    bulge_chase_planar; y = (y_r, y_i) of shape (n, m)."""
    if g is None:
        g = b
    y_r, y_i = y
    plan = _wave_plan(n, b, g)
    with trace_range("apply_q2_planar_repack"):
        v2f, t2f, nvp, kp = _padded_pack_planar(vt, taut, b, n, g, plan["n_groups"], plan["kmax"])
    fy = plan["fy"]
    yp_r = torch.zeros((plan["rows_p"], y_r.shape[1]), dtype=y_r.dtype, device=y_r.device)
    yp_i = torch.zeros_like(yp_r)
    yp_r[fy : fy + n] = y_r
    yp_i[fy : fy + n] = y_i

    with trace_range("apply_q2_planar"):
        ridx_all, rows_all = _wave_indices(plan, n, b, g, nvp, kp, y_r.device)
        for ridx, rows in zip(ridx_all, rows_all):
            q = window_q_planar(*_planar_staircase(v2f, t2f, ridx, g, b))
            yp_r[rows], yp_i[rows] = _pbmm(q, (yp_r[rows], yp_i[rows]))
    return yp_r[fy : fy + n].clone(), yp_i[fy : fy + n].clone()
