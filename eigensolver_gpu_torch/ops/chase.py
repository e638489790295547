"""Band -> tridiagonal bulge chase in one call (kernels K7, real, and K8,
planar).

Replaces the Pallas kernel ``bulge_chase_pallas``
(eigensolver_gpu_tpu/ops/chase_pallas.py:929; ``pallas_call`` :1009,
``_chase_kernel`` :240, ``_window_update`` :162). The CUDA source is
``csrc/chase.cu``; its header states what bounds the kernel on the H100
and what its design does about it.

Contract: ``bulge_chase_kernel(band, b)`` takes the (n, 2b) lower band
storage of ops/sb2st.dense_to_band and returns ``(d, e, vt, taut)`` in
the layout of ops/sb2st.bulge_chase (``vt`` has ``t3 = 3*ceil(t_total/3)``
rows, not the Pallas kernel's multiple of its timestep block). Inactive
slots hold ``tau = 0`` and ``v = 0``; the plain version leaves the unused
``v`` of an inactive slot as its arithmetic produced it, and no reader
looks at a reflector whose ``tau`` is 0. Any n >= 3 and 2 <= b <= 64.

``bulge_chase_kernel`` is the wrapper: a CUDA tensor launches the kernel
(and raises if it cannot be built or launched), a CPU tensor takes
``ops/sb2st.bulge_chase``, the plain version. float32 and float64.

``bulge_chase_planar_kernel`` (kernel K8) is the planar complex twin. It
replaces ``bulge_chase_planar_pallas`` (chase_pallas.py:804; ``pallas_call``
:880, ``_chase_kernel_planar`` :723, ``_window_update_planar`` :601); the
CUDA source is ``csrc/chase_planar.cu``. It takes the two (n, 2b) lower
band planes (the imaginary plane holds ``-Im(upper)``) and returns
``(d, (e_r, e_i), (vt_r, vt_i), (taut_r, taut_i))`` in the layout of
``ops/sb2st_planar.bulge_chase_planar``, its plain version. The Pallas
module's opt-in ``batch3`` re-staging gives the same outputs from another
schedule of the TPU's memory and has no counterpart here.

Both kernels are one persistent cooperative launch whose blocks order the
timesteps through per-slot progress flags; the wrapper hands it those flags
as a zeroed int32 scratch of ``s_slots`` words, and the launch raises if
its blocks cannot all be resident at once.

Both also take a batch of bands, a ``(batch, n, 2b)`` band or pair of
planes (the batched two-stage solves of ``sygvdx_batched`` and
``zhegvdx_planar_batched``): one launch chases them all, its blocks owning
(item, slot) pairs, with a flag a pair (``(batch, s_slots)`` words), and the
outputs gain the leading axis. Each item's outputs are the bits of a launch
on that item alone. The grid is the pairs, capped at the blocks that fit on
the card at once (``chase_blocks`` and ``chase_planar_blocks`` report it).
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.ops.sb2st import bulge_chase, chase_dims
from eigensolver_gpu_torch.ops.sb2st_planar import bulge_chase_planar
from eigensolver_gpu_torch.utils import kernel_guard
from eigensolver_gpu_torch.utils.tracing import trace_range

B_MAX = 64  # kMaxB of csrc/chase.cu


def bulge_chase_kernel(band, b):
    """Kernel K7: the whole chase (see the module docstring). A leading
    batch axis of the band is one launch for the whole batch."""
    b = int(b)
    if band.ndim not in (2, 3) or band.shape[-1] != 2 * b:
        raise ValueError(f"band must be (n, 2b={2 * b}), with at most one batch axis, got "
                         f"{tuple(band.shape)}")
    n = band.shape[-2]
    if n < 3 or not 2 <= b <= B_MAX:
        raise ValueError(f"bulge_chase_kernel needs n >= 3 and 2 <= b <= {B_MAX}; got n={n}, b={b}")
    if band.device.type == "cpu":
        return bulge_chase(band, b)
    if band.dtype == torch.float32:
        name = "bulge_chase_f32_launch"
    elif band.dtype == torch.float64:
        name = "bulge_chase_f64_launch"
    else:
        raise TypeError(f"the chase kernel takes float32 or float64, got {band.dtype}")
    fn = getattr(kernel_guard.load("chase"), name)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    s_slots, _, t3 = chase_dims(n, b)
    dev = band.device
    lead = band.shape[:-2]
    batch = lead[0] if lead else 1
    work = band.clone(memory_format=torch.contiguous_format)  # chased in place
    vt = torch.zeros(lead + (t3, s_slots, b), dtype=band.dtype, device=dev)
    taut = torch.zeros(lead + (t3, s_slots), dtype=band.dtype, device=dev)
    progress = torch.zeros(lead + (s_slots,), dtype=torch.int32, device=dev)  # the flags
    with trace_range("bulge_chase"), torch.cuda.device(dev):
        status = fn(
            work.data_ptr(), n, b, batch, vt.data_ptr(), taut.data_ptr(), progress.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        kernel_guard.check(status, "bulge_chase launch")
        bulge_chase_kernel.launches += 1
    return work[..., 0].clone(), work[..., : n - 1, 1].clone(), vt, taut


bulge_chase_kernel.launches = 0


def bulge_chase_planar_kernel(band_r, band_i, b):
    """Kernel K8: the whole planar chase (see the module docstring). A
    leading batch axis of the planes is one launch for the whole batch."""
    b = int(b)
    if band_r.ndim not in (2, 3) or band_r.shape[-1] != 2 * b or band_i.shape != band_r.shape:
        raise ValueError(f"both band planes must be (n, 2b={2 * b}), with at most one batch "
                         f"axis, got {tuple(band_r.shape)} and {tuple(band_i.shape)}")
    if band_i.dtype != band_r.dtype or band_i.device != band_r.device:
        raise ValueError("bulge_chase_planar_kernel: the planes differ in dtype or device")
    n = band_r.shape[-2]
    if n < 3 or not 2 <= b <= B_MAX:
        raise ValueError(
            f"bulge_chase_planar_kernel needs n >= 3 and 2 <= b <= {B_MAX}; got n={n}, b={b}")
    if band_r.device.type == "cpu":
        return bulge_chase_planar(band_r, band_i, b)
    if band_r.dtype == torch.float32:
        name = "bulge_chase_planar_f32_launch"
    elif band_r.dtype == torch.float64:
        name = "bulge_chase_planar_f64_launch"
    else:
        raise TypeError(f"the planar chase kernel takes float32 or float64, got {band_r.dtype}")
    fn = getattr(kernel_guard.load("chase_planar"), name)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    s_slots, _, t3 = chase_dims(n, b)
    dev = band_r.device
    lead = band_r.shape[:-2]
    batch = lead[0] if lead else 1
    work_r = band_r.clone(memory_format=torch.contiguous_format)  # chased in place
    work_i = band_i.clone(memory_format=torch.contiguous_format)
    vt = torch.zeros((2,) + lead + (t3, s_slots, b), dtype=band_r.dtype, device=dev)
    taut = torch.zeros((2,) + lead + (t3, s_slots), dtype=band_r.dtype, device=dev)
    progress = torch.zeros(lead + (s_slots,), dtype=torch.int32, device=dev)  # the flags
    with trace_range("bulge_chase_planar"), torch.cuda.device(dev):
        status = fn(
            work_r.data_ptr(), work_i.data_ptr(), n, b, batch,
            vt[0].data_ptr(), vt[1].data_ptr(), taut[0].data_ptr(), taut[1].data_ptr(),
            progress.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        kernel_guard.check(status, "bulge_chase_planar launch")
        bulge_chase_planar_kernel.launches += 1
    e = (work_r[..., : n - 1, 1].clone(), work_i[..., : n - 1, 1].clone())
    return work_r[..., 0].clone(), e, (vt[0], vt[1]), (taut[0], taut[1])


bulge_chase_planar_kernel.launches = 0


def _grid_blocks(source, entry, b, pairs, dtype):
    fn = getattr(kernel_guard.load(source), entry)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    kernel_guard.check(fn(int(b), int(pairs), int(dtype == torch.float64), ctypes.byref(out)),
                       entry)
    return out.value


def chase_blocks(b, pairs, dtype):
    """The number of blocks G of K7's launch for ``pairs`` (item, slot)
    pairs at half-width ``b`` in ``dtype`` (the pairs, capped at the blocks
    that fit on the current card at once); it builds the kernel if needed."""
    return _grid_blocks("chase", "bulge_chase_blocks", b, pairs, dtype)


def chase_planar_blocks(b, pairs, dtype):
    """``chase_blocks`` for K8."""
    return _grid_blocks("chase_planar", "bulge_chase_planar_blocks", b, pairs, dtype)
