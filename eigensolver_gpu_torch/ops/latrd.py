"""One 32-column zlatrd panel of the planar hetrd (kernel K2).

Replaces the Pallas kernel ``latrd_panel_planar``
(eigensolver_gpu_tpu/ops/latrd_pallas.py:300; ``pallas_call`` :333,
``_latrd_kernel`` :228, ``_phase`` :58), the fused form of the
reference's per-column chain zher2_mv_zlarfg -> zhemv -> stacked_zgemv
(zhetrd_gpu.F90:142-163). The CUDA source is ``csrc/latrd_panel.cu``;
its header states what bounds it on the H100 and how the design answers
that.

The contract is the Pallas function's: for the planar pair (mb, mb) and
columns [panel_end - nb, panel_end), processed in descending order,
return ``(vr, vi, wr, wi, colr, coli, scal)`` -- the compact-WY panels
and the packed columns, (mb, nb) in SLOT order (slot k = column
panel_end-1-k), and ``scal`` (4, nb) with rows (d, e, tau_r, tau_i) per
slot. The input planes are not modified; their row stride may exceed
mb (a bucket is a view of the full planes).

A leading batch axis (the Pallas function under ``jax.vmap``): (B, mb,
mb) views of (B, n, n) planes, one ``panel_end`` for all items; the seven
outputs gain a leading B. A batch is one launch, and each item's outputs
are the bits of its unbatched launch.

``latrd_panel_planar`` is the wrapper: a CUDA tensor launches the
kernel (and raises if it cannot), a CPU tensor takes
``latrd_panel_plain``, which runs the same panel through the eager
column loop of ops/sytrd_planar.py on a copy and reads the slots out.
The kernel is one cooperative launch a panel; it raises when its
ceil(mb / 32) blocks cannot all be resident on the card. A batch runs on
as many groups of those blocks as are resident at once, each group taking
its items in turn.
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.utils import kernel_guard

MB_MAX = 4096
NB_MAX = 32


def latrd_panel_plain(ar_mb, ai_mb, panel_end, nb=32):
    """Plain PyTorch version of kernel K2 (same contract)."""
    from eigensolver_gpu_torch.ops.sytrd_planar import _panel_columns_planar

    mb = ar_mb.shape[-1]
    ar = ar_mb.clone()
    ai = ai_mb.clone()
    d = torch.zeros(ar.shape[:-2] + (mb,), dtype=ar.dtype, device=ar.device)
    e, taur, taui = torch.zeros_like(d), torch.zeros_like(d), torch.zeros_like(d)
    vr, vi, wr, wi = _panel_columns_planar(ar, ai, d, e, taur, taui, panel_end, nb)
    cols = torch.arange(panel_end - 1, panel_end - 1 - nb, -1, device=ar.device)
    has_r = cols > 0
    below = (cols - 1).clamp_min(0)
    scal = torch.stack([
        d[..., cols],
        torch.where(has_r, e[..., below], 0.0),
        torch.where(has_r, taur[..., below], 0.0),
        torch.where(has_r, taui[..., below], 0.0),
    ], dim=-2)
    return vr, vi, wr, wi, ar[..., :, cols], ai[..., :, cols], scal


def _check(ar, ai, panel_end, nb):
    mb, lead = ar.shape[-1], tuple(ar.shape[:-2])
    if len(lead) > 1 or ar.shape != lead + (mb, mb) or ai.shape != ar.shape:
        raise ValueError(f"latrd planes must be square, with at most one batch axis, "
                         f"got {ar.shape}, {ai.shape}")
    if ar.dtype != torch.float32 or ai.dtype != torch.float32:
        raise TypeError("latrd panel kernel takes float32 planes")
    if ar.device != ai.device:
        raise ValueError("latrd planes on different devices")
    if not (1 <= nb <= NB_MAX and nb <= panel_end <= mb <= MB_MAX):
        raise ValueError(
            f"latrd needs 1 <= nb <= {NB_MAX}, nb <= panel_end <= mb <= {MB_MAX}; "
            f"got nb={nb}, panel_end={panel_end}, mb={mb}"
        )
    if ar.stride(-1) != 1 or ar.stride() != ai.stride():
        raise ValueError("latrd planes need unit column stride and one row (and batch) stride")


def latrd_panel_planar(ar_mb, ai_mb, panel_end, nb=32):
    """Kernel K2: one fused zlatrd panel (see the module docstring)."""
    panel_end = int(panel_end)
    _check(ar_mb, ai_mb, panel_end, nb)
    if ar_mb.device.type == "cpu":
        return latrd_panel_plain(ar_mb, ai_mb, panel_end, nb)
    lib = kernel_guard.load("latrd_panel")
    fn = lib.latrd_panel_planar_launch
    V, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [V, V, I, ctypes.c_longlong, I, I, I, V, V, V, I, V]
    fn.restype = ctypes.c_int
    lib.latrd_panel_scratch_floats.argtypes = [ctypes.c_int]
    lib.latrd_panel_scratch_floats.restype = ctypes.c_int
    mb, lead = ar_mb.shape[-1], tuple(ar_mb.shape[:-2])
    batch = lead[0] if lead else 1
    sa = ar_mb.stride(0) if lead and batch > 1 else 0
    dev = ar_mb.device
    # slot-major work planes [vr vi wr wi colr coli] an item, so a slot is
    # contiguous; the kernel writes every entry of them and of scal
    pan = torch.empty(lead + (6, nb, mb), dtype=torch.float32, device=dev)
    scal = torch.empty(lead + (4, nb), dtype=torch.float32, device=dev)
    scratch = torch.empty((batch * lib.latrd_panel_scratch_floats(mb),), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        status = fn(
            ar_mb.data_ptr(), ai_mb.data_ptr(), ar_mb.stride(-2), sa, mb, panel_end, nb,
            pan.data_ptr(), scal.data_ptr(), scratch.data_ptr(), batch,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_guard.check(status, "latrd_panel_planar launch")
    latrd_panel_planar.launches += 1
    vr, vi, wr, wi, colr, coli = (pan[..., j, :, :].mT for j in range(6))
    return vr, vi, wr, wi, colr, coli, scal


latrd_panel_planar.launches = 0
