"""Device timing with CUDA events, and the host's monotonic clock (the
port's counterpart of eigensolver_gpu_tpu/utils/timer.py).

:func:`wallclock` is the JAX package's ``wallclock``: seconds of
CLOCK_MONOTONIC, which the JAX package reads through a small C library
(its csrc/wallclock.c, the reference's test_driver/wallclock.c:30-42) and
the port through ``time.clock_gettime``, the same clock with no build.

PyTorch returns before the device finishes, so a host clock without a
synchronize measures the enqueue. :func:`device_ms` brackets ``iters``
calls with CUDA events and reports the mean device milliseconds per
call; :func:`wall_ms` times whole calls on the host clock, each ending
in ``torch.cuda.synchronize()``.

A call whose kernels are shorter than the host takes to enqueue them
(tens of microseconds for a wrapper that checks its arguments and
allocates its outputs) would be timed at the host's pace, events or not.
So :func:`device_ms` first parks the stream behind a device-side spin of
some tens of milliseconds: the host enqueues the timed calls meanwhile,
and the events then bracket back-to-back device work. Calls whose host
cost exceeds their device time by more than that head start (the plain
eager versions) are still timed at the host's pace, which is their cost.
"""

from __future__ import annotations

import time

import torch

_HEAD_START_CYCLES = 60_000_000  # about 30 ms at the H100's 1.98 GHz boost clock


def wallclock() -> float:
    """Seconds from the host's monotonic clock (CLOCK_MONOTONIC)."""
    return time.clock_gettime(time.CLOCK_MONOTONIC)


def device_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(_HEAD_START_CYCLES)
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
