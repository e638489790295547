"""Device timing with CUDA events (the port's counterpart of
eigensolver_gpu_tpu/utils/timer.py, whose native wallclock timed the
JAX harness from the host).

PyTorch returns before the device finishes, so a host clock without a
synchronize measures the enqueue. :func:`device_ms` brackets ``iters``
calls with CUDA events and reports the mean device milliseconds per
call; :func:`wall_ms` times whole calls on the host clock, each ending
in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time

import torch


def device_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def wall_ms(fn, iters: int = 3) -> list[float]:
    """Host-clock ms of each of ``iters`` calls, each ended by a sync."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
