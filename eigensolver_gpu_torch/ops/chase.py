"""Band -> tridiagonal bulge chase in one call (kernel K7).

Replaces the Pallas kernel ``bulge_chase_pallas``
(eigensolver_gpu_tpu/ops/chase_pallas.py:929; ``pallas_call`` :1009,
``_chase_kernel`` :240, ``_window_update`` :162). The CUDA source is
``csrc/chase.cu``; its header states what bounds the kernel on the H100
and why it is a sequence of launches from one C call.

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
"""

from __future__ import annotations

import ctypes

import torch

from eigensolver_gpu_torch.ops.sb2st import bulge_chase, chase_dims
from eigensolver_gpu_torch.utils import kernel_guard
from eigensolver_gpu_torch.utils.tracing import trace_range

B_MAX = 64  # kMaxB of csrc/chase.cu


def bulge_chase_kernel(band, b):
    """Kernel K7: the whole chase (see the module docstring)."""
    b = int(b)
    if band.ndim != 2 or band.shape[1] != 2 * b:
        raise ValueError(f"band must be (n, 2b={2 * b}), got {tuple(band.shape)}")
    n = band.shape[0]
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
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    s_slots, _, t3 = chase_dims(n, b)
    work = band.clone(memory_format=torch.contiguous_format)  # chased in place
    vt = torch.zeros((t3, s_slots, b), dtype=band.dtype, device=band.device)
    taut = torch.zeros((t3, s_slots), dtype=band.dtype, device=band.device)
    with trace_range("bulge_chase"), torch.cuda.device(band.device):
        status = fn(
            work.data_ptr(), n, b, vt.data_ptr(), taut.data_ptr(),
            torch.cuda.current_stream(band.device).cuda_stream,
        )
        kernel_guard.check(status, "bulge_chase launch")
        bulge_chase_kernel.launches += 1
    return work[:, 0].clone(), work[: n - 1, 1].clone(), vt, taut


bulge_chase_kernel.launches = 0
