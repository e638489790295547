"""QL factorization of one panel strip of the band reduction, with the
forward-larft T of its reflectors (kernels K5, real, and K6, planar).

Replaces the Pallas kernel ``ql_panel_pallas``
(eigensolver_gpu_tpu/ops/ql_panel_pallas.py:287; ``pallas_call`` :301,
``_ql_panel_kernel`` :41). The CUDA source is ``csrc/ql_panel.cu``; its
header states what bounds the kernel on the H100 and what the design does
about it.

Contract (the Pallas function's): ``ql_panel(p, rows_below)`` takes the
(m, b) panel and returns ``(r_panel (m, b), v (m, b), tau (b,), t (b, b))``:
column j, last to first, is zeroed in rows [0, rows_below + j) against its
pivot at row rows_below + j; rows past the pivot are untouched; ``t`` is
the forward-larft factor with H(0) .. H(b-1) = I - V T V^T. Any m >= 1
and 1 <= b <= 64 (the Pallas ``m % 128`` and ``b % 8`` rules are tiling
rules of its compiler and are not carried over). The panel may be a column
slice of a row-major matrix: the kernel takes its row stride.

``ql_panel`` is the wrapper: a CUDA tensor launches the kernel (and raises
if it cannot be built or launched), a CPU tensor takes ``ql_panel_plain``,
which is ``sbrd._ql_panel`` followed by ``sbrd._larft_forward``. The
kernel takes float32 and float64. It spreads the panel's active rows over
the blocks of one thread-block cluster, a row slab each; the launch raises
if the cluster cannot be co-resident.

``ql_panel`` also takes a batch of panels, a ``(batch, m, b)`` panel that
may be a column slice of ``(batch, n, n)`` matrices (a batch stride of its
own, no copy): one launch with a cluster an item (sbrd's panel step of a
batched solve), the outputs with a leading batch axis, each item's the bits
of a launch on that item alone.

``ql_panel_planar`` (kernel K6) is the planar complex twin. It replaces
``ql_panel_planar_pallas`` (ql_panel_pallas.py:251; ``pallas_call`` :263,
``_ql_panel_planar_kernel`` :129); the CUDA source is
``csrc/ql_panel_planar.cu``. ``ql_panel_planar(pr, pi, rows_below)`` returns
``(pf_r, pf_i, v_r, v_i, tau_r, tau_i, t_r, t_i)``: per column, last to
first, a planar zlarfg (real beta written to the pivot with a zero
imaginary part, complex tau; a column with a zero tail AND a real pivot is
trivial), the columns to its left updated with ``H^H``, and ``t`` the
forward larft of the CONJUGATED taus, so that
``H(0)^H .. H(b-1)^H = I - V T V^H``. Same shapes, strides and types as
``ql_panel``; both planes share one row stride. Its plain version is
``ql_panel_planar_plain``: ``sbrd_planar._ql_panel_planar`` followed by
``sbrd_planar._larft_forward_planar(v, tau_r, -tau_i)``. The kernel spreads
the panel's active rows over the blocks of one thread-block cluster, a row
slab each; the launch raises if the cluster cannot be co-resident.

``ql_panel_planar`` also takes a batch of panels, ``(batch, m, b)`` planes
that may be column slices of ``(batch, n, n)`` matrices (a batch stride of
their own, no copy): one launch with a cluster an item (psbrd's panel step
of a batched solve), the outputs with a leading batch axis, each item's the
bits of a launch on that item alone.
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.ops.sbrd import _larft_forward, _ql_panel
from eigensolver_gpu_torch.ops.sbrd_planar import _larft_forward_planar, _ql_panel_planar
from eigensolver_gpu_torch.utils import kernel_guard

B_MAX = 64  # kMaxB of csrc/ql_panel.cu

def ql_panel_plain(p, rows_below):
    """Plain PyTorch version of kernel K5 (same contract)."""
    r_panel, v, tau = _ql_panel(p, rows_below)
    return r_panel, v, tau, _larft_forward(v, tau)


def ql_panel(p, rows_below):
    """Kernel K5: one fused QL panel with its T (see the module docstring).
    A leading batch axis of the panel is one launch for the whole batch, a
    cluster an item."""
    rows_below = int(rows_below)
    if p.ndim not in (2, 3):
        raise ValueError("ql_panel takes an (m, b) panel, with at most one batch axis, got "
                         f"shape {tuple(p.shape)}")
    m, b = p.shape[-2:]
    lead = p.shape[:-2]
    if not (1 <= b <= B_MAX and 0 <= rows_below <= m - b):
        raise ValueError(
            f"ql_panel needs 1 <= b <= {B_MAX} and 0 <= rows_below <= m - b; "
            f"got m={m}, b={b}, rows_below={rows_below}"
        )
    if p.device.type == "cpu":
        return ql_panel_plain(p, rows_below)
    if p.dtype == torch.float32:
        name = "ql_panel_f32_launch"
    elif p.dtype == torch.float64:
        name = "ql_panel_f64_launch"
    else:
        raise TypeError(f"the ql_panel kernel takes float32 or float64, got {p.dtype}")
    if p.stride(-1) != 1 or p.stride(-2) < b:
        raise ValueError("ql_panel: the panel needs unit column stride and row stride >= b")
    batch = lead[0] if lead else 1
    fn = getattr(kernel_guard.load("ql_panel"), name)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    new = lambda *shape: torch.empty(lead + shape, dtype=p.dtype, device=p.device)
    r_panel, v, tau, t = new(m, b), new(m, b), new(b), new(b, b)
    with torch.cuda.device(p.device):
        status = fn(
            p.data_ptr(), p.stride(-2), p.stride(0) if lead else 0, m, b, rows_below, batch,
            r_panel.data_ptr(), v.data_ptr(), tau.data_ptr(), t.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    kernel_guard.check(status, "ql_panel launch")
    ql_panel.launches += 1
    return r_panel, v, tau, t


ql_panel.launches = 0


def ql_panel_planar_plain(pr, pi, rows_below):
    """Plain PyTorch version of kernel K6 (same contract)."""
    pf_r, pf_i, v_r, v_i, tau_r, tau_i = _ql_panel_planar(pr, pi, rows_below)
    t_r, t_i = _larft_forward_planar(v_r, v_i, tau_r, -tau_i)
    return pf_r, pf_i, v_r, v_i, tau_r, tau_i, t_r, t_i


def ql_panel_planar(pr, pi, rows_below):
    """Kernel K6: one fused planar QL panel with its conjugated-tau T (see
    the module docstring). A leading batch axis of the planes is one launch
    for the whole batch, a cluster an item."""
    rows_below = int(rows_below)
    if pr.ndim not in (2, 3) or pi.shape != pr.shape:
        raise ValueError("ql_panel_planar takes two (m, b) planes, with at most one batch "
                         f"axis, got shapes {tuple(pr.shape)} and {tuple(pi.shape)}")
    if pi.dtype != pr.dtype or pi.device != pr.device:
        raise ValueError("ql_panel_planar: the planes differ in dtype or device")
    m, b = pr.shape[-2:]
    lead = pr.shape[:-2]
    if not (1 <= b <= B_MAX and 0 <= rows_below <= m - b):
        raise ValueError(
            f"ql_panel_planar needs 1 <= b <= {B_MAX} and 0 <= rows_below <= m - b; "
            f"got m={m}, b={b}, rows_below={rows_below}"
        )
    if pr.device.type == "cpu":
        return ql_panel_planar_plain(pr, pi, rows_below)
    if pr.dtype == torch.float32:
        name = "ql_panel_planar_f32_launch"
    elif pr.dtype == torch.float64:
        name = "ql_panel_planar_f64_launch"
    else:
        raise TypeError(f"the ql_panel_planar kernel takes float32 or float64, got {pr.dtype}")
    if pr.stride(-1) != 1 or pi.stride(-1) != 1 or pr.stride(-2) < b \
            or pi.stride(-2) != pr.stride(-2):
        raise ValueError("ql_panel_planar: the planes need unit column stride and one common "
                         "row stride >= b")
    batch = lead[0] if lead else 1
    if batch > 1 and pi.stride(0) != pr.stride(0):
        raise ValueError("ql_panel_planar: the planes need one common batch stride")
    fn = getattr(kernel_guard.load("ql_panel_planar"), name)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    new = lambda *shape: torch.empty(lead + shape, dtype=pr.dtype, device=pr.device)
    outs = (new(m, b), new(m, b), new(m, b), new(m, b), new(b), new(b), new(b, b), new(b, b))
    with torch.cuda.device(pr.device):
        status = fn(
            pr.data_ptr(), pi.data_ptr(), pr.stride(-2), pr.stride(0) if lead else 0, m, b,
            rows_below, batch, *(x.data_ptr() for x in outs),
            torch.cuda.current_stream(pr.device).cuda_stream,
        )
    kernel_guard.check(status, "ql_panel_planar launch")
    ql_panel_planar.launches += 1
    return outs


ql_panel_planar.launches = 0
