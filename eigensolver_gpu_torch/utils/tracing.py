"""Profiler range annotations (twin of eigensolver_gpu_tpu/utils/tracing.py).

The reference wraps each pipeline phase in NVTX ranges and, when asked,
synchronizes the device at each range end so a range brackets device
time. Here a range is a ``torch.profiler.record_function`` (it shows in
``torch.profiler`` traces under the same names as the JAX package's
``named_scope``s) plus an NVTX range when CUDA is present; with
``sync=True`` the range end synchronizes the device and records the
host-clock seconds. Off until :func:`enable`; when off a range costs
one flag test.
"""

from __future__ import annotations

import contextlib
import time

import torch

_ENABLED = False
_SYNC = False
_records: list[tuple[str, float]] = []


def enable(sync: bool = False) -> None:
    global _ENABLED, _SYNC
    _ENABLED = True
    _SYNC = sync


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def timings() -> list[tuple[str, float]]:
    """(name, seconds) records collected by synchronizing ranges."""
    return list(_records)


def clear() -> None:
    _records.clear()


@contextlib.contextmanager
def trace_range(name: str):
    """Label a pipeline phase; with sync mode also time it to the device."""
    if not _ENABLED:
        yield
        return
    cuda = torch.cuda.is_available()
    if _SYNC and cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if cuda:
            torch.cuda.nvtx.range_pop()
    if _SYNC:
        if cuda:
            torch.cuda.synchronize()
        _records.append((name, time.perf_counter() - t0))
