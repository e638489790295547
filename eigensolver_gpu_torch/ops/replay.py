"""Replay of the bulge-chase reflectors, y <- Q2 y, in one call (kernel K9).

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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from eigensolver_gpu_torch.ops.sb2st import _padded_pack, _staircase, apply_q2, window_q
from eigensolver_gpu_torch.utils import kernel_guard
from eigensolver_gpu_torch.utils.precision import highest_precision
from eigensolver_gpu_torch.utils.tracing import trace_range

P = 128  # stored window size (kP of csrc/replay.cu), the largest l_win
SLOT_ROUND = 4  # the JAX layout rounds the slot count to a multiple of 4
_CHUNK = 8  # waves of windows formed per batched pass


def _geometry(n, b, g):
    """Static wave-schedule geometry (numpy), mirrors ops/sb2st.apply_q2."""
    kmax = max((n - 3) // b, 0)
    n_groups = -(-max(n - 2, 1) // g)
    n_u = kmax // 2 + 1
    n_act = min(n_u, -(-(n - 2) // (g + 2 * b)) + 1)
    n_waves = 2 * (n_groups - 1) + kmax + 1
    waves = np.arange(n_waves)
    par = waves % 2
    return dict(
        kmax=kmax, l_win=b + g - 1, n_groups=n_groups, n_u=n_u, n_act=n_act,
        n_waves=n_waves, par=par, c0=n_groups - 1 - (waves - par) // 2,
        n_slots=-(-n_act // SLOT_ROUND) * SLOT_ROUND,
    )


def _wave_gather(geo, n, b, g, kp, nvp):
    """Slot i of wave tau -> window (j, k) -> first row of its g reflectors
    in the (kp, nvp, b)-padded sweep-major pack, flattened. Returns
    (valid (n_waves, n_slots) bool, flat_idx (n_waves, n_slots, g)); invalid
    slots index zero padding (sweep n_groups*g.., k row kp-1). The clamp of
    the first slot matches csrc/replay.cu."""
    n_groups, n_slots = geo["n_groups"], geo["n_slots"]
    u_lo = np.minimum(np.maximum(0, -geo["c0"]), max(geo["n_u"] - n_slots, 0))
    u = u_lo[:, None] + np.arange(n_slots)[None, :]
    jarr = geo["c0"][:, None] + u
    karr = geo["par"][:, None] + 2 * u
    valid = ((jarr >= 0) & (jarr < n_groups) & (karr <= geo["kmax"])
             & (jarr * g + karr * b <= n - 3))
    jj = np.where(valid, jarr, n_groups)
    kk = np.where(valid, karr, kp - 1)
    return valid, kk[:, :, None] * nvp + jj[:, :, None] * g + np.arange(g)


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
    _, flat_idx = _wave_gather(geo, n, b, g, kp, nvp)
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
