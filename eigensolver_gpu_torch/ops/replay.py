"""Replay of the bulge-chase reflectors, y <- Q2 y, in one call (kernels
K9, real, and K10, planar).

Replaces the Pallas kernel ``apply_q2_pallas``
(eigensolver_gpu_tpu/ops/replay_pallas.py:674; ``pallas_call`` :763,
``_replay_kernel_resident`` :225, ``_replay_kernel`` :414, ``_wave_body``
:96, ``_wave_body_twophase`` :160). The CUDA source is ``csrc/replay.cu``;
its header states what bounds the kernel on the H100 and what the design
does about it.

As in the JAX module the work splits in two. ``window_qs`` precomputes, in
batched library products outside the kernel, the explicit orthogonal of
every (wave, slot) window of the schedule of ops/sb2st.apply_q2; the
kernel then applies them wave after wave, each window one
``Q (l_win x l_win) @ y[rows, :]`` product computed in the kernel's own
body. ``window_qs`` keeps the JAX layout, ``(n_waves, n_slots, 128, 128)``
with the window in the leading ``l_win x l_win`` block, identity on the
rest of the diagonal and in invalid slots, and ``n_slots`` the active slot
count rounded up to a multiple of 4 (the clamp of the first slot read
depends on it, so it is part of the layout). The kernel reads and writes
exactly ``l_win`` rows per window.

``apply_q2_kernel`` is the wrapper: a CUDA tensor launches the kernel (and
raises if it cannot be built or launched), a CPU tensor takes
``ops/sb2st.apply_q2`` with ``tsolve='qform'``, the plain version.
float32 and float64; any m >= 1; any b >= 2, g >= 1 with
``l_win = b + g - 1 <= 128``.

``apply_q2_planar_kernel`` (kernel K10) is the planar complex twin. It
replaces ``apply_q2_planar_pallas`` (replay_pallas.py:560; ``pallas_call``
:646, ``_replay_kernel_planar`` :538, ``_wave_body`` :96, windows from
``window_qs_planar`` :433); the CUDA source is ``csrc/replay_planar.cu``.
``window_qs_planar`` returns ONE tensor ``(2, n_waves, n_slots, 128, 128)``,
plane 0 the real parts and plane 1 the imaginary parts of the window
unitaries (the JAX function concatenates the two planes of a window into a
(128, 256) block ``[Q_r | Q_i]``; ``torch.cat([qw[0], qw[1]], dim=-1)`` gives
that block). An invalid slot holds ``Q_r = I``, ``Q_i = 0``. vt, taut and y
are ``(re, im)`` pairs; the plain version is
``ops/sb2st_planar.apply_q2_planar``.
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.ops.sb2st import (
    _padded_pack,
    _staircase,
    _wave_gather,
    _wave_plan,
    apply_q2,
    window_q,
)
from eigensolver_gpu_torch.ops.sb2st_planar import (
    _padded_pack_planar,
    _planar_staircase,
    apply_q2_planar,
    window_q_planar,
)
from eigensolver_gpu_torch.utils import kernel_guard
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range

P = 128  # stored window size (kP of csrc/replay.cu), the largest l_win
SLOT_ROUND = 4  # the JAX layout rounds the slot count to a multiple of 4
_CHUNK = 8  # waves of windows formed per batched pass


def _geometry(n, b, g):
    """The wave schedule of ops/sb2st._wave_plan at the window store's slot
    count: ``n_slots`` is a multiple of 4 and the clamp of the first slot
    read follows it, as csrc/replay.cu and csrc/replay_planar.cu compute it."""
    return _wave_plan(n, b, g, slot_round=SLOT_ROUND)


@highest_precision
def window_qs(vt, taut, n, b, g):
    """Every wave-slot's window orthogonal, batched: qw
    (n_waves, n_slots, 128, 128) with qw[tau, i] = [[Q, 0], [0, I]], Q the
    (l_win, l_win) compact-WY orthogonal of window
    (j = c0+u_lo+i, k = par+2(u_lo+i)), or the identity for an invalid slot.
    ``_CHUNK`` waves are formed at a time to bound the temporaries."""
    geo = _geometry(n, b, g)
    l_win, n_waves, n_slots = geo["l_win"], geo["n_waves"], geo["n_slots"]
    if l_win > P:
        raise ValueError(f"l_win = b + g - 1 = {l_win} exceeds the stored window size {P}")
    dev = vt.device
    v2f, t2f, nvp, kp = _padded_pack(vt, taut, b, n, g, geo["n_groups"], geo["kmax"])
    _, flat_idx = _wave_gather(geo, n, b, g, nvp, kp)
    flat_idx = torch.from_numpy(flat_idx).to(dev)
    qw = torch.zeros((n_waves, n_slots, P, P), dtype=vt.dtype, device=dev)
    tail = torch.arange(l_win, P, device=dev)
    qw[:, :, tail, tail] = 1.0
    for w0 in range(0, n_waves, _CHUNK):
        idx = flat_idx[w0 : w0 + _CHUNK]
        taus = t2f[idx]
        qw[w0 : w0 + _CHUNK, :, :l_win, :l_win] = window_q(_staircase(v2f[idx], taus, g, b), taus)
    return qw


def apply_q2_kernel(vt, taut, y, n, b, g=None):
    """Kernel K9: y <- Q2 y (see the module docstring). ``g`` defaults to
    3b, as in the Pallas function."""
    if g is None:
        g = 3 * b
    n, b, g = int(n), int(b), int(g)
    if b + g - 1 > P:
        raise ValueError(f"l_win = b + g - 1 = {b + g - 1} exceeds the window size {P}")
    if b < 2 or g < 1 or n < 3:
        raise ValueError(f"apply_q2_kernel needs n >= 3, b >= 2, g >= 1; got {n}, {b}, {g}")
    if y.ndim != 2 or y.shape[0] != n or y.shape[1] < 1:
        raise ValueError(f"y must be (n={n}, m >= 1), got {tuple(y.shape)}")
    if y.dtype != vt.dtype or y.device != vt.device:
        raise ValueError("apply_q2_kernel: y and the reflectors differ in dtype or device")
    if y.device.type == "cpu":
        return apply_q2(vt, taut, y, n, b, g=g, tsolve="qform")
    if y.dtype == torch.float32:
        name = "apply_q2_f32_launch"
    elif y.dtype == torch.float64:
        name = "apply_q2_f64_launch"
    else:
        raise TypeError(f"the replay kernel takes float32 or float64, got {y.dtype}")
    fn = getattr(kernel_guard.load("replay"), name)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with trace_range("apply_q2_qs"):
        qw = window_qs(vt, taut, n, b, g)
    out = y.clone(memory_format=torch.contiguous_format)  # updated in place
    m = out.shape[1]
    with trace_range("apply_q2"), torch.cuda.device(y.device):
        status = fn(
            qw.data_ptr(), out.data_ptr(), out.stride(0), n, m, b, g,
            qw.shape[0], qw.shape[1],
            torch.cuda.current_stream(y.device).cuda_stream,
        )
        kernel_guard.check(status, "apply_q2 launch")
        apply_q2_kernel.launches += 1
    return out


apply_q2_kernel.launches = 0


@highest_precision
def window_qs_planar(vt, taut, n, b, g):
    """Every wave-slot's planar window unitary, batched: qw
    (2, n_waves, n_slots, 128, 128), plane 0 real and plane 1 imaginary,
    with qw[:, tau, i] = [[Q, 0], [0, I]], Q the (l_win, l_win) compact-WY
    unitary of the window that ``window_qs`` puts in this slot, or the
    identity for an invalid slot."""
    geo = _geometry(n, b, g)
    l_win, n_waves, n_slots = geo["l_win"], geo["n_waves"], geo["n_slots"]
    if l_win > P:
        raise ValueError(f"l_win = b + g - 1 = {l_win} exceeds the stored window size {P}")
    dev = vt[0].device
    v2f, t2f, nvp, kp = _padded_pack_planar(vt, taut, b, n, g, geo["n_groups"], geo["kmax"])
    _, flat_idx = _wave_gather(geo, n, b, g, nvp, kp)
    flat_idx = torch.from_numpy(flat_idx).to(dev)
    qw = torch.zeros((2, n_waves, n_slots, P, P), dtype=vt[0].dtype, device=dev)
    tail = torch.arange(l_win, P, device=dev)
    qw[0, :, :, tail, tail] = 1.0
    for w0 in range(0, n_waves, _CHUNK):
        q_r, q_i = window_q_planar(*_planar_staircase(v2f, t2f, flat_idx[w0 : w0 + _CHUNK], g, b))
        qw[0, w0 : w0 + _CHUNK, :, :l_win, :l_win] = q_r
        qw[1, w0 : w0 + _CHUNK, :, :l_win, :l_win] = q_i
    return qw


def apply_q2_planar_kernel(vt, taut, y, n, b, g=None):
    """Kernel K10: planar y <- Q2 y (see the module docstring). ``g``
    defaults to 3b, as in the Pallas function."""
    if g is None:
        g = 3 * b
    n, b, g = int(n), int(b), int(g)
    y_r, y_i = y
    if b + g - 1 > P:
        raise ValueError(f"l_win = b + g - 1 = {b + g - 1} exceeds the window size {P}: "
                         f"take g <= {P + 1 - b}, or the plain apply_q2_planar")
    if b < 2 or g < 1 or n < 3:
        raise ValueError(f"apply_q2_planar_kernel needs n >= 3, b >= 2, g >= 1; got {n}, {b}, {g}")
    if y_r.ndim != 2 or y_r.shape[0] != n or y_r.shape[1] < 1 or y_i.shape != y_r.shape:
        raise ValueError(f"both planes of y must be (n={n}, m >= 1), got "
                         f"{tuple(y_r.shape)} and {tuple(y_i.shape)}")
    if any(x.dtype != y_r.dtype or x.device != y_r.device for x in (y_i, *vt, *taut)):
        raise ValueError("apply_q2_planar_kernel: y and the reflectors differ in dtype or device")
    if y_r.device.type == "cpu":
        return apply_q2_planar(vt, taut, y, n, b, g=g)
    if y_r.dtype == torch.float32:
        name = "apply_q2_planar_f32_launch"
    elif y_r.dtype == torch.float64:
        name = "apply_q2_planar_f64_launch"
    else:
        raise TypeError(f"the planar replay kernel takes float32 or float64, got {y_r.dtype}")
    fn = getattr(kernel_guard.load("replay_planar"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with trace_range("apply_q2_planar_qs"):
        qw = window_qs_planar(vt, taut, n, b, g)
    m = y_r.shape[1]
    out = torch.empty((2, n, m), dtype=y_r.dtype, device=y_r.device)  # updated in place
    out[0], out[1] = y_r, y_i
    with trace_range("apply_q2_planar"), torch.cuda.device(y_r.device):
        status = fn(
            qw[0].data_ptr(), qw[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            m, n, m, b, g, qw.shape[1], qw.shape[2],
            torch.cuda.current_stream(y_r.device).cuda_stream,
        )
        kernel_guard.check(status, "apply_q2_planar launch")
        apply_q2_planar_kernel.launches += 1
    return out[0], out[1]


apply_q2_planar_kernel.launches = 0
