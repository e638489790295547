"""One run of one cell: set-up, the closed-loop window, the check, the result line.

A caller issues one solver call after another, each ending in
``torch.cuda.synchronize()``, as an SCF loop does once per k-point: a call is
one solve, or one batched call of the cell's whole batch. Call ``i`` solves
problem ``i % pool`` of the pool the input generator made from the seed.

Untraced (``trace=False``) the window only times: per call the host clock and
the solver's own memory peak. Traced, the window has three parts: one call per
problem of the pool profiled with CUDA activity alone (kernel times, the
device's busy time and the calls' wall time; no ranges), one call profiled with
the host's activity too (what the host did in the device's idle gaps), then
calls with synchronising ranges (stage times and ``stedc.sweeps`` per call)
until the window's seconds are up.

A seeded reservoir keeps the outputs of ``KEEP`` calls of the window, copied
into buffers made in set-up, before the warm-up call; the profiled calls are
not among them. ``info`` is read for every call. Once the window has closed and
the memory peak is read, ``check.py`` judges the kept outputs against the
reference.
"""

from __future__ import annotations

import importlib
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from port_bench import check, spec, trace

KEEP = 8  # calls of the window whose outputs are judged
STAGES = "eigensolver_gpu_torch.utils.tracing"
STEDC = "eigensolver_gpu_torch.ops.stedc"


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def build(names):
    """Load the cell's kernels, building the missing ones all at once."""
    from eigensolver_gpu_torch.utils import kernel_guard

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        for fut in [ex.submit(kernel_guard.load, name) for name in names]:
            fut.result()


def resolve(dotted):
    mod, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


class Loop:
    """The closed loop over the pool: timing, memory peaks, kept outputs."""

    def __init__(self, torch, call, pool, seed, cuda):
        self.torch, self.call, self.pool, self.cuda = torch, call, pool, cuda
        self.rng = random.Random(seed)
        self.times, self.peaks, self.bad = [], [], []
        self.proc_peak = 0
        self.slots, self.kept, self.seen = [], [], 0

    def one(self, i):
        torch = self.torch
        if self.cuda:
            self.proc_peak = max(self.proc_peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = self.call(i % self.pool)
        if self.cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if self.cuda:
            self.peaks.append(torch.cuda.max_memory_allocated() - base)
        return out, t0, t1

    def warm(self, shapes):
        """The kept outputs' buffers, then one call."""
        torch = self.torch
        self.slots = [tuple(torch.empty(shape, dtype=getattr(torch, dtype), device=device)
                            for shape, dtype, device in shapes) for _ in range(KEEP)]
        self.one(0)
        self.times, self.peaks = [], []

    def record(self, i, out, t0, t1, keep=True):
        self.times.append(t1 - t0)
        self.bad.append(out[-1])  # info is the last field
        if not keep:
            return
        self.seen += 1
        j = self.seen - 1 if self.seen <= KEEP else self.rng.randrange(self.seen)
        if j < KEEP:
            for dst, src in zip(self.slots[j], out):
                dst.copy_(src)
            if j < len(self.kept):
                self.kept[j] = (i, i % self.pool)
            else:
                self.kept.append((i, i % self.pool))

    def bad_items(self):
        """Items a call whose info is not 0, for every call of the window."""
        return [int((info != 0).sum()) for info in self.bad]

    def peak(self):
        if self.cuda:
            self.proc_peak = max(self.proc_peak, self.torch.cuda.max_memory_allocated())
        return self.proc_peak


def window(loop, seconds):
    """Calls until ``seconds`` have passed (at least one); its wall seconds."""
    i, begin = 0, time.perf_counter()
    while True:
        out, t0, t1 = loop.one(i)
        loop.record(i, out, t0, t1)
        del out
        i += 1
        if t1 - begin >= seconds:
            return t1 - begin


def traced_window(torch, loop, seconds, keys, pool, cuda):
    """The traced window: two profiled parts, then synchronising ranges."""
    from torch.profiler import record_function

    tracing, stedc = importlib.import_module(STAGES), importlib.import_module(STEDC).stedc
    i, begin, spans = 0, time.perf_counter(), []

    def calls(count, ranges=False):
        nonlocal i
        for _ in range(count):
            if ranges:
                with record_function(trace.CALL):
                    out, t0, t1 = loop.one(i)
            else:
                out, t0, t1 = loop.one(i)
            loop.record(i, out, t0, t1, keep=False)
            spans.append(t1 - t0)
            del out
            i += 1

    try:
        prof = None
        if cuda:
            got = trace.profile_calls(torch, lambda: calls(pool), keys)
            prof = trace.device_time(got)
            prof.update(calls=pool, window_ns=sum(spans[-pool:]) * 1e9)
            tracing.enable(sync=False)
            prof["idle_ns"] = trace.idle_gaps(trace.profile_calls(
                torch, lambda: calls(1, ranges=True), host=True))
        staged = []
        tracing.enable(sync=True)
        while True:
            tracing.clear()
            out, t0, t1 = loop.one(i)
            loop.record(i, out, t0, t1)
            del out
            staged.append({"seconds": t1 - t0, "ranges": tracing.timings(),
                           "sweeps": list(getattr(stedc, "sweeps", []))})
            i += 1
            if t1 - begin >= seconds:
                break
    finally:
        tracing.disable()
        tracing.clear()
    return time.perf_counter() - begin, prof, staged


def run_cell(cell, seed, seconds, trace_on, device, t_start, entry=None):
    """The result dict of one run and the check's rows; ``entry`` replaces
    the configuration's entry point (the tests' broken timed paths)."""
    import torch

    from eigensolver_gpu_torch.utils.config import SolverConfig

    wl, cfg = cell.workload, cell.config
    kind, batched = cfg["input"], wl["batch"] > 1
    cuda = device == "cuda"
    marks = [("imports", time.perf_counter())]
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.init()
        marks.append(("cuda", time.perf_counter()))
        build(cfg["build"])
        marks.append(("kernels", time.perf_counter()))
    if entry is None:
        entry = resolve(cfg["entries"]["batched" if batched else "single"])
    solver = SolverConfig(**cfg["solver"])
    il, iu, pool_size = wl["il"], wl["iu"], wl["pool"]
    pool = spec.module("inputs", wl["inputs"]).make(wl["n"], wl["batch"], pool_size, seed,
                                                    device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("inputs", time.perf_counter()))
    loop = Loop(torch, lambda p: entry(*pool[p], il=il, iu=iu, cfg=solver), pool_size, seed,
                cuda)
    loop.warm(check.result_shapes(kind, wl["n"], iu - il + 1, wl["batch"], device))
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", time.perf_counter()))
    log("setup_s:", " ".join(f"{name} {t - prev:.3f}" for (name, t), prev
                             in zip(marks, [t_start] + [t for _, t in marks])))

    rec = {"cell": wl, "config": cfg, "setup_s": setup_s, "profile": None,
           "staged": []}
    if trace_on:
        wall, rec["profile"], rec["staged"] = traced_window(
            torch, loop, seconds, list(cfg["kernels"].values()), pool_size, cuda)
    else:
        wall = window(loop, seconds)
    rec.update(calls_s=loop.times, window_s=wall, call_peaks=loop.peaks)
    peak = loop.peak()
    if cuda:
        torch.cuda.empty_cache()  # the program's cached blocks, before the reference runs

    # the check: every call's info, the kept calls' outputs against the reference
    bad = loop.bad_items()
    kept = [(i, p, out) for (i, p), out in zip(loop.kept, loop.slots)]
    worst, failed = check.worst(kind, pool, kept, il, iu, batched, wl["limits"])
    worst["info_bad"] = float(sum(bad))
    failed |= {i for i, b in enumerate(bad) if b}
    correct, rows = check.judge(worst, wl["limits"])

    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(bad), "failed": len(failed),
              "metrics": metrics, "device": device_info(torch, cuda, peak)}
    if trace_on and rec["profile"]:
        prof = rec["profile"]
        result["device"]["busy_s"] = prof["busy_ns"] / 1e9
        result["device"]["window_s"] = prof["window_ns"] / 1e9
        result["breakdown"] = {"device_ops": trace.top(prof["kernels"]),
                               "idle_gaps": trace.top(prof["idle_ns"])}
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    log("calls_ms:", " ".join(f"{t * 1e3:.1f}" for t in loop.times))
    return result, rows


def device_info(torch, cuda, peak):
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}
