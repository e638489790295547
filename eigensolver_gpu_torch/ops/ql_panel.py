"""QL factorization of one panel strip of the band reduction, with the
forward-larft T of its reflectors (kernel K5).

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
kernel takes float32 and float64.
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.ops.sbrd import _larft_forward, _ql_panel
from eigensolver_gpu_torch.utils import kernel_guard

B_MAX = 64  # kMaxB of csrc/ql_panel.cu


def ql_panel_plain(p, rows_below):
    """Plain PyTorch version of kernel K5 (same contract)."""
    r_panel, v, tau = _ql_panel(p, rows_below)
    return r_panel, v, tau, _larft_forward(v, tau)


def ql_panel(p, rows_below):
    """Kernel K5: one fused QL panel with its T (see the module docstring)."""
    rows_below = int(rows_below)
    if p.ndim != 2:
        raise ValueError(f"ql_panel takes an (m, b) panel, got shape {tuple(p.shape)}")
    m, b = p.shape
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
    if p.stride(1) != 1 or p.stride(0) < b:
        raise ValueError("ql_panel: the panel needs unit column stride and row stride >= b")
    fn = getattr(kernel_guard.load("ql_panel"), name)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    r_panel = torch.empty((m, b), dtype=p.dtype, device=p.device)
    v = torch.empty_like(r_panel)
    tau = torch.empty((b,), dtype=p.dtype, device=p.device)
    t = torch.empty((b, b), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        status = fn(
            p.data_ptr(), p.stride(0), m, b, rows_below,
            r_panel.data_ptr(), v.data_ptr(), tau.data_ptr(), t.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    kernel_guard.check(status, "ql_panel launch")
    ql_panel.launches += 1
    return r_panel, v, tau, t


ql_panel.launches = 0
