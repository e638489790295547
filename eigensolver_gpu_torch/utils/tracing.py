"""Spans and counters of the port (twin of eigensolver_gpu_tpu/utils/tracing.py).

The reference wraps each pipeline phase in NVTX ranges and, when asked,
synchronizes the device at each range end so a range brackets device
time. Here a range (:func:`trace_range`) is a
``torch.profiler.record_function`` (it shows in ``torch.profiler`` traces
under the same names as the JAX package's ``named_scope``s) plus an NVTX
range when CUDA is present. Off until :func:`enable`; while off,
:func:`trace_range` and :func:`count` each cost one flag test: no
``record_function``, no NVTX, no clock read, no record.

While on, each range that closes leaves a span record (:func:`export`):

  * ``name``;
  * ``start_ns``, ``end_ns``: ``time.time_ns()`` (CLOCK_REALTIME, ns since
    the Unix epoch), the middle of the ``record_function``'s enter and the
    moment its exit returns. That is the clock of ``torch.profiler``'s
    events: the ``start_ns()`` and ``end_ns()`` of its kineto records are
    Unix-epoch ns. Under the profiler an enter takes tens of µs and stamps
    its annotation's start about midway, an exit stamps the end near its
    return, so a span lines up with its range's user annotation;
  * ``id``: its place in the order in which spans opened since
    :func:`enable`, and ``parent``: the ``id`` of the span open around it
    (None at the top);
  * ``call``: the number of :func:`clear` calls since :func:`enable`; a
    call runs from one ``clear()`` to the next;
  * ``counts``: what :func:`count` added while it was the innermost open
    span.

The records stay from ``enable()`` to the next ``enable()``; ``clear()``
and :func:`disable` keep them. The newest ``MAX_SPANS`` are kept.

With ``enable(sync=True)`` a range synchronizes the device where it opens
and before it closes, and :func:`timings` gives ``(name, seconds)`` of
each range closed since the last ``clear()``: the host clock between the
two synchronizations, so a range brackets its device time.

``count(name, k)`` adds ``k`` under the innermost open span, and drops it
where no span is open. The module counts one thing itself, ``host_sync``:
while tracing is on, CUDA's sync debug mode is ``"warn"`` and each warning
of a synchronizing CUDA operation is counted instead of shown. The
module's own synchronizations and syncs with no span open (a caller's
synchronize after a call) are not counted. ``disable()`` restores the
debug mode, the warning filters and ``warnings.showwarning``.

Spans nest on one stack: trace from one thread at a time.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings

import torch

MAX_SPANS = 1 << 16
HOST_SYNC = "host_sync"
SYNC_WARNING = "called a synchronizing CUDA operation"

_ENABLED = False
_SYNC = False
_OFF = contextlib.nullcontext()
_records: list[tuple[str, float]] = []  # (name, seconds) since clear()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_stack: list[dict] = []  # open spans, innermost last
_next_id = 0
_call = 0
_own_sync = False
_hooked = None  # (catch_warnings, the debug mode before) while counting host syncs


def enable(sync: bool = False) -> None:
    """Turn tracing on; drop the span records of the last ``enable()``."""
    global _ENABLED, _SYNC, _next_id, _call
    _ENABLED = True
    _SYNC = sync
    _spans.clear()
    _next_id = 0
    _call = 0
    if _hooked is None:
        _hook_host_syncs()


def disable() -> None:
    """Turn tracing off; restore the sync debug mode and the warning filters."""
    global _ENABLED, _hooked
    _ENABLED = False
    if _hooked is not None:
        saved, mode = _hooked
        _hooked = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        saved.__exit__(None, None, None)


def timings() -> list[tuple[str, float]]:
    """(name, seconds) records collected by synchronizing ranges."""
    return list(_records)


def clear() -> None:
    """Drop the timings and start the next call of the span records."""
    global _call
    _records.clear()
    _call += 1


def export() -> list[dict]:
    """The span records since the last ``enable()``, in the order the spans
    opened (module docstring)."""
    return [dict(s, counts=dict(s["counts"])) for s in sorted(_spans, key=lambda s: s["id"])]


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to ``name`` under the innermost open span."""
    if not _ENABLED:
        return
    if _stack:
        counts = _stack[-1]["counts"]
        counts[name] = counts.get(name, 0) + k


def trace_range(name: str):
    """Label a pipeline phase; with sync mode also time it to the device."""
    if not _ENABLED:
        return _OFF
    return _Range(name)


class _Range:
    __slots__ = ("name", "cuda", "span", "t0", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _next_id
        self.cuda = torch.cuda.is_available()
        if _SYNC and self.cuda:
            _synchronize()
        self.t0 = time.perf_counter()
        if self.cuda:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = torch.profiler.record_function(self.name)
        t = time.time_ns()
        self.rf.__enter__()
        self.span = {"id": _next_id, "name": self.name, "start_ns": (t + time.time_ns()) // 2,
                     "end_ns": None, "parent": _stack[-1]["id"] if _stack else None,
                     "call": _call, "counts": {}}
        _next_id += 1
        _stack.append(self.span)

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None and _SYNC and self.cuda:
                _synchronize()
        finally:
            _stack.pop()
            self.rf.__exit__(exc_type, exc, tb)
            self.span["end_ns"] = time.time_ns()
            if self.cuda:
                torch.cuda.nvtx.range_pop()
        if exc_type is None:
            _spans.append(self.span)
            if _SYNC:
                _records.append((self.name, time.perf_counter() - self.t0))
        return False


def _synchronize():
    global _own_sync
    _own_sync = True
    try:
        torch.cuda.synchronize()
    finally:
        _own_sync = False


def _hook_host_syncs():
    """Count sync warnings (module docstring): every one of them reaches
    ``warnings.showwarning``, which counts it and passes the others on."""
    global _hooked
    saved = warnings.catch_warnings()
    saved.__enter__()
    show = warnings.showwarning

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            if not _own_sync:
                count(HOST_SYNC)
            return
        show(message, category, filename, lineno, file, line)

    warnings.filterwarnings("always", message=SYNC_WARNING)
    warnings.showwarning = on_warning
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _hooked = (saved, mode)
