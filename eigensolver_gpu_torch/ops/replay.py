"""Replay of the bulge-chase reflectors, y <- Q2 y, in one call (kernels
K9, real, and K10, planar).

Replaces the Pallas kernel ``apply_q2_pallas``
(eigensolver_gpu_tpu/ops/replay_pallas.py:674; ``pallas_call`` :763,
``_replay_kernel_resident`` :225, ``_replay_kernel`` :414, ``_wave_body``
:96, ``_wave_body_twophase`` :160). The CUDA source is ``csrc/replay.cu``;
its header states what bounds the kernel on the H100 and what the design
does about it.

As in the JAX module the work splits in two. A window pass precomputes, in
batched library products outside the kernel, the explicit orthogonal of
each window of the schedule of ops/sb2st.apply_q2; the kernel then applies
them in replay order, each window one ``Q (l_win x l_win) @ y[rows, :]``
product computed in the kernel's own body. The window pass forms the valid
windows only: ``window_table`` lists them in replay order (wave after wave,
slots ascending) from the static geometry, and ``window_store`` forms their
orthogonals into a compact store ``(n_valid, 128, 128)`` (2 795 of the
5 936 slots at n = 4096, b = 32, g = 96); the kernel runs through the store
in one launch. ``window_qs`` keeps the JAX layout, ``(n_waves, n_slots,
128, 128)`` with the window in the leading ``l_win x l_win`` block,
identity on the rest of the diagonal and in invalid slots, and ``n_slots``
the active slot count rounded up to a multiple of 4 (the clamp of the
first slot read depends on it, so it is part of the layout): the compact
store scattered into identity slots. The kernel reads and writes exactly
``l_win`` rows per window.

``apply_q2_kernel`` is the wrapper: a CUDA tensor launches the kernel (and
raises if it cannot be built or launched), a CPU tensor takes
``ops/sb2st.apply_q2`` with ``tsolve='qform'``, the plain version.
float32 and float64; any m >= 1; any b >= 2, g >= 1 with
``l_win = b + g - 1 <= 128``.

``apply_q2_planar_kernel`` (kernel K10) is the planar complex twin. It
replaces ``apply_q2_planar_pallas`` (replay_pallas.py:560; ``pallas_call``
:646, ``_replay_kernel_planar`` :538, ``_wave_body`` :96, windows from
``window_qs_planar`` :433); the CUDA source is ``csrc/replay_planar.cu``.
Its window pass forms the valid windows only: ``window_table`` lists them
in replay order (wave after wave, slots ascending) from the static
geometry, and ``window_store_planar`` forms their unitaries, in the same
batched library products as before, into a compact store
``(2, n_valid, 128, 128)``, as ``window_store`` does for K9; the kernel
runs through the store in order. ``window_qs_planar``
keeps the JAX layout, ONE tensor ``(2, n_waves, n_slots, 128, 128)``, plane
0 the real parts and plane 1 the imaginary parts of the window unitaries
(the JAX function concatenates the two planes of a window into a (128, 256)
block ``[Q_r | Q_i]``; ``torch.cat([qw[0], qw[1]], dim=-1)`` gives that
block): the compact store scattered into identity-filled slots, so an
invalid slot holds ``Q_r = I``, ``Q_i = 0``. vt, taut and y are
``(re, im)`` pairs; the plain version is ``ops/sb2st_planar.apply_q2_planar``.

K9 and K10 also take a batch of problems (the batched two-stage solves of
``sygvdx_batched`` and ``zhegvdx_planar_batched``): vt, taut and y with a
leading batch axis, one window table for the batch, the store ``(batch,
n_valid, 128, 128)`` (K10: ``(2, batch, n_valid, 128, 128)``, about 1.6 GB
in fp32 for 64 items at n = 1024) and one launch whose blocks each replay
one item's 32 columns. ``replay_store`` and ``replay_planar_store`` are
those launches on a formed store; each item's result is the bits of the
launch on its windows alone.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
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
_WINDOWS = 256  # valid windows formed per batched pass (window_store, window_store_planar)


def _geometry(n, b, g):
    """The wave schedule of ops/sb2st._wave_plan at the window store's slot
    count: ``n_slots`` is a multiple of 4 and the clamp of the first slot
    read follows it, as csrc/replay.cu and csrc/replay_planar.cu compute it."""
    return _wave_plan(n, b, g, slot_round=SLOT_ROUND)


def window_table(n, b, g):
    """The valid windows of the replay's wave schedule (at the window
    store's slot count, see ``_geometry``), in replay order: wave after
    wave, slots ascending. A dict with the geometry ``geo``, the
    (n_waves, n_slots) ``valid`` mask of ``_wave_gather``, and numpy arrays
    over the valid windows: ``wave`` and ``slot`` (the window's place in
    the layout of ``window_qs_planar``), ``row0`` (its first row of y),
    ``ridx`` (n_valid, g), the rows of the padded reflector pack that hold
    its reflectors; and ``wave_ptr`` (n_waves + 1,): the windows of wave w
    are entries wave_ptr[w] : wave_ptr[w + 1]."""
    geo = _geometry(n, b, g)
    valid, ridx = _wave_gather(geo, n, b, g, geo["n_groups"] * g + g, geo["kmax"] + 2)
    wave, slot = np.nonzero(valid)
    return dict(geo=geo, valid=valid, wave=wave, slot=slot,
                row0=geo["base"][wave] + slot * geo["spacing"], ridx=ridx[wave, slot],
                wave_ptr=np.concatenate([[0], np.cumsum(valid.sum(axis=1))]))


@highest_precision
def window_store(vt, taut, n, b, g):
    """The window orthogonals of the valid windows only, in replay order:
    ``(store, table)`` with ``table = window_table(n, b, g)`` and store
    (n_valid, 128, 128), store[v] = [[Q, 0], [0, I]] for window v of the
    table, Q its (l_win, l_win) compact-WY orthogonal. Leading (batch) axes
    of vt and taut lead the store: (..., n_valid, 128, 128), one table for
    the batch. About ``_WINDOWS`` windows (of all items) are formed at a
    time to bound the temporaries."""
    table = window_table(n, b, g)
    geo = table["geo"]
    l_win = geo["l_win"]
    if l_win > P:
        raise ValueError(f"l_win = b + g - 1 = {l_win} exceeds the stored window size {P}")
    dev = vt.device
    lead = taut.shape[:-2]
    v2f, t2f, _, _ = _padded_pack(vt, taut, b, n, g, geo["n_groups"], geo["kmax"])
    ridx = torch.from_numpy(table["ridx"]).to(dev)
    store = torch.zeros(lead + (ridx.shape[0], P, P), dtype=vt.dtype, device=dev)
    tail = torch.arange(l_win, P, device=dev)
    store[..., tail, tail] = 1.0
    step = max(1, _WINDOWS // max(1, math.prod(lead)))
    for v0 in range(0, ridx.shape[0], step):
        idx = ridx[v0 : v0 + step]
        taus = t2f[..., idx]
        store[..., v0 : v0 + step, :l_win, :l_win] = window_q(
            _staircase(v2f[..., idx, :], taus, g, b), taus)
    return store, table


def window_qs(vt, taut, n, b, g):
    """Every wave-slot's window orthogonal in the JAX layout: qw
    (n_waves, n_slots, 128, 128) with qw[tau, i] = [[Q, 0], [0, I]], Q the
    (l_win, l_win) compact-WY orthogonal of window
    (j = c0+u_lo+i, k = par+2(u_lo+i)), or the identity for an invalid slot:
    the compact store of ``window_store`` scattered into an identity-filled
    layout. Leading (batch) axes of vt and taut lead qw."""
    store, table = window_store(vt, taut, n, b, g)
    geo = table["geo"]
    dev = store.device
    lead = store.shape[:-3]
    qw = torch.zeros(lead + (geo["n_waves"], geo["n_slots"], P, P), dtype=store.dtype,
                     device=dev)
    diag = torch.arange(P, device=dev)
    qw[..., diag, diag] = 1.0
    wave = torch.from_numpy(table["wave"]).to(dev)
    slot = torch.from_numpy(table["slot"]).to(dev)
    qw[..., wave, slot, :, :] = store
    return qw


def apply_q2_kernel(vt, taut, y, n, b, g=None):
    """Kernel K9: y <- Q2 y (see the module docstring). ``g`` defaults to
    3b, as in the Pallas function. A leading batch axis of the reflectors
    and of y is one launch for the whole batch."""
    if g is None:
        g = 3 * b
    n, b, g = int(n), int(b), int(g)
    if b + g - 1 > P:
        raise ValueError(f"l_win = b + g - 1 = {b + g - 1} exceeds the window size {P}")
    if b < 2 or g < 1 or n < 3:
        raise ValueError(f"apply_q2_kernel needs n >= 3, b >= 2, g >= 1; got {n}, {b}, {g}")
    if y.ndim not in (2, 3) or y.shape[-2] != n or y.shape[-1] < 1:
        raise ValueError(f"y must be (n={n}, m >= 1), with at most one batch axis, got "
                         f"{tuple(y.shape)}")
    lead = y.shape[:-2]
    if vt.shape[: len(lead)] != lead or vt.ndim != len(lead) + 3 \
            or taut.shape[: len(lead)] != lead or taut.ndim != len(lead) + 2:
        raise ValueError("apply_q2_kernel: the reflectors' batch axes differ from y's")
    if y.dtype != vt.dtype or y.device != vt.device:
        raise ValueError("apply_q2_kernel: y and the reflectors differ in dtype or device")
    if y.device.type == "cpu":
        return apply_q2(vt, taut, y, n, b, g=g, tsolve="qform")
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the replay kernel takes float32 or float64, got {y.dtype}")
    with trace_range("apply_q2_qs"):
        store, table = window_store(vt, taut, n, b, g)
        row0 = torch.from_numpy(table["row0"].astype(np.int32)).to(y.device)
    return replay_store(store, row0, y, table["geo"]["l_win"])


def replay_store(store, row0, y, l_win):
    """The launch of kernel K9 on a formed window store: y <- Q2 y with the
    windows of ``store`` ([batch,] n_valid, 128, 128) applied in order at
    the rows ``row0`` (n_valid int32 on the card, one table for the batch)
    to y ([batch,] n, m); returns the new y. ``apply_q2_kernel`` is the
    window pass followed by this."""
    lead = y.shape[:-2]
    n, m = y.shape[-2:]
    if store.shape[: len(lead)] != lead or store.dim() != 3 + len(lead) \
            or store.shape[-2:] != (P, P) or store.shape[-3] != row0.numel():
        raise ValueError(f"replay_store: store {tuple(store.shape)} does not fit y "
                         f"{tuple(y.shape)} and {row0.numel()} windows")
    if any(x.device.type != "cuda" for x in (store, row0, y)):
        raise ValueError("replay_store launches kernel K9: its tensors must be on the card")
    if y.dtype == torch.float32:
        name = "apply_q2_f32_launch"
    elif y.dtype == torch.float64:
        name = "apply_q2_f64_launch"
    else:
        raise TypeError(f"the replay kernel takes float32 or float64, got {y.dtype}")
    fn = getattr(kernel_guard.load("replay"), name)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = y.device
    store = store.contiguous()
    batch = lead[0] if lead else 1
    ldy = -(-m // 4) * 4  # 16-byte rows for the kernel's copies
    out = (torch.empty if ldy == m else torch.zeros)(lead + (n, ldy), dtype=y.dtype, device=dev)
    out[..., :m] = y  # updated in place
    with trace_range("apply_q2"), torch.cuda.device(dev):
        status = fn(
            store.data_ptr(), row0.data_ptr(), row0.numel(), out.data_ptr(), ldy, n, m,
            l_win, batch, torch.cuda.current_stream(dev).cuda_stream,
        )
        kernel_guard.check(status, "apply_q2 launch")
        apply_q2_kernel.launches += 1
    return out if ldy == m else out[..., :m].contiguous()


apply_q2_kernel.launches = 0


@highest_precision
def window_store_planar(vt, taut, n, b, g):
    """The planar window unitaries of the valid windows only, in replay
    order: ``(store, table)`` with ``table = window_table(n, b, g)`` and
    store (2, n_valid, 128, 128), plane 0 real and plane 1 imaginary,
    store[:, v] = [[Q, 0], [0, I]] for window v of the table, Q its
    (l_win, l_win) compact-WY unitary. Leading (batch) axes of vt and taut
    come after the plane axis: store (2, ..., n_valid, 128, 128), one
    table for the batch. About ``_WINDOWS`` windows (of all items) are
    formed at a time to bound the temporaries."""
    table = window_table(n, b, g)
    geo = table["geo"]
    l_win = geo["l_win"]
    if l_win > P:
        raise ValueError(f"l_win = b + g - 1 = {l_win} exceeds the stored window size {P}")
    dev = vt[0].device
    lead = taut[0].shape[:-2]
    v2f, t2f, _, _ = _padded_pack_planar(vt, taut, b, n, g, geo["n_groups"], geo["kmax"])
    ridx = torch.from_numpy(table["ridx"]).to(dev)
    store = torch.zeros((2,) + lead + (ridx.shape[0], P, P), dtype=vt[0].dtype, device=dev)
    tail = torch.arange(l_win, P, device=dev)
    store[0, ..., tail, tail] = 1.0
    step = max(1, _WINDOWS // max(1, math.prod(lead)))
    for v0 in range(0, ridx.shape[0], step):
        q_r, q_i = window_q_planar(*_planar_staircase(v2f, t2f, ridx[v0 : v0 + step], g, b))
        store[0, ..., v0 : v0 + step, :l_win, :l_win] = q_r
        store[1, ..., v0 : v0 + step, :l_win, :l_win] = q_i
    return store, table


def window_qs_planar(vt, taut, n, b, g):
    """Every wave-slot's planar window unitary in the JAX layout: qw
    (2, n_waves, n_slots, 128, 128), plane 0 real and plane 1 imaginary,
    with qw[:, tau, i] = [[Q, 0], [0, I]], Q the (l_win, l_win) compact-WY
    unitary of the window that ``window_qs`` puts in this slot, or the
    identity for an invalid slot: the compact store of
    ``window_store_planar`` scattered into an identity-filled layout.
    Leading (batch) axes of vt and taut come after the plane axis."""
    store, table = window_store_planar(vt, taut, n, b, g)
    geo = table["geo"]
    dev = store.device
    lead = store.shape[1:-3]
    qw = torch.zeros((2,) + lead + (geo["n_waves"], geo["n_slots"], P, P), dtype=store.dtype,
                     device=dev)
    diag = torch.arange(P, device=dev)
    qw[0, ..., diag, diag] = 1.0
    wave = torch.from_numpy(table["wave"]).to(dev)
    slot = torch.from_numpy(table["slot"]).to(dev)
    qw[:, ..., wave, slot, :, :] = store
    return qw


def apply_q2_planar_kernel(vt, taut, y, n, b, g=None):
    """Kernel K10: planar y <- Q2 y (see the module docstring). ``g``
    defaults to 3b, as in the Pallas function. A leading batch axis of the
    reflectors and of y is one launch for the whole batch."""
    if g is None:
        g = 3 * b
    n, b, g = int(n), int(b), int(g)
    y_r, y_i = y
    if b + g - 1 > P:
        raise ValueError(f"l_win = b + g - 1 = {b + g - 1} exceeds the window size {P}: "
                         f"take g <= {P + 1 - b}, or the plain apply_q2_planar")
    if b < 2 or g < 1 or n < 3:
        raise ValueError(f"apply_q2_planar_kernel needs n >= 3, b >= 2, g >= 1; got {n}, {b}, {g}")
    if y_r.ndim not in (2, 3) or y_r.shape[-2] != n or y_r.shape[-1] < 1 \
            or y_i.shape != y_r.shape:
        raise ValueError(f"both planes of y must be (n={n}, m >= 1), with at most one batch "
                         f"axis, got {tuple(y_r.shape)} and {tuple(y_i.shape)}")
    lead = y_r.shape[:-2]
    if any(x.shape[: len(lead)] != lead or x.ndim != len(lead) + k
           for x, k in ((vt[0], 3), (vt[1], 3), (taut[0], 2), (taut[1], 2))):
        raise ValueError("apply_q2_planar_kernel: the reflectors' batch axes differ from y's")
    if any(x.dtype != y_r.dtype or x.device != y_r.device for x in (y_i, *vt, *taut)):
        raise ValueError("apply_q2_planar_kernel: y and the reflectors differ in dtype or device")
    if y_r.device.type == "cpu":
        return apply_q2_planar(vt, taut, y, n, b, g=g)
    if y_r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the planar replay kernel takes float32 or float64, got {y_r.dtype}")
    with trace_range("apply_q2_planar_qs"):
        store, table = window_store_planar(vt, taut, n, b, g)
        row0 = torch.from_numpy(table["row0"].astype(np.int32)).to(y_r.device)
    return replay_planar_store(store, row0, y, table["geo"]["l_win"])


def replay_planar_store(store, row0, y, l_win):
    """The launch of kernel K10 on a formed window store: y <- Q2 y with
    the windows of ``store`` (2, [batch,] n_valid, 128, 128) applied in
    order at the rows ``row0`` (n_valid int32 on the card, one table for the
    batch) to the planes y = (y_r, y_i), ([batch,] n, m); returns the new
    planes. ``apply_q2_planar_kernel`` is the window pass followed by this."""
    y_r, y_i = y
    lead = y_r.shape[:-2]
    n, m = y_r.shape[-2:]
    if store.shape[1 : 1 + len(lead)] != lead or store.dim() != 4 + len(lead) \
            or store.shape[-2:] != (P, P) or store.shape[-3] != row0.numel():
        raise ValueError(f"replay_planar_store: store {tuple(store.shape)} does not fit y "
                         f"{tuple(y_r.shape)} and {row0.numel()} windows")
    if any(x.device.type != "cuda" for x in (store, row0, y_r, y_i)):
        raise ValueError("replay_planar_store launches kernel K10: its tensors must be on "
                         "the card")
    if y_r.dtype == torch.float32:
        name = "apply_q2_planar_f32_launch"
    elif y_r.dtype == torch.float64:
        name = "apply_q2_planar_f64_launch"
    else:
        raise TypeError(f"the planar replay kernel takes float32 or float64, got {y_r.dtype}")
    fn = getattr(kernel_guard.load("replay_planar"), name)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = y_r.device
    store = store.contiguous()
    batch = lead[0] if lead else 1
    ldy = -(-m // 4) * 4  # 16-byte rows for the kernel's copies
    out = (torch.empty if ldy == m else torch.zeros)((2,) + lead + (n, ldy), dtype=y_r.dtype,
                                                     device=dev)
    out[0, ..., :m], out[1, ..., :m] = y_r, y_i  # updated in place
    with trace_range("apply_q2_planar"), torch.cuda.device(dev):
        status = fn(
            store[0].data_ptr(), store[1].data_ptr(), row0.data_ptr(), row0.numel(),
            out[0].data_ptr(), out[1].data_ptr(), ldy, n, m, l_win, batch,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        kernel_guard.check(status, "apply_q2_planar launch")
        apply_q2_planar_kernel.launches += 1
    if ldy == m:
        return out[0], out[1]
    return out[0, ..., :m].contiguous(), out[1, ..., :m].contiguous()


apply_q2_planar_kernel.launches = 0
