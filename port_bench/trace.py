"""Reading profiled calls: device busy time, kernel times and idle gaps.

Two ``torch.profiler`` sessions read the raw kineto records. One with CUDA
activity alone and no ranges covers a few timed calls: the device's kernels,
copies and sets give the busy time and each kernel's time, and the host's clock
around the calls the window (recording host operations would slow the host and
lengthen the device's gaps). One with CPU activity too covers one call, inside a
``record_function`` named ``CALL``: there each idle gap of the device is named
by what the host was doing, the program's innermost stage range
(``utils/tracing.py``, recorded as user annotations) and its innermost host
operation. A profile that caught no device record, or none of a kernel that the
cell's metrics read, is no reading: it is taken again, up to ``TRIES`` times
(the card's profiler has dropped records now and then).
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

CALL = "port_bench.call"
TRIES = 4
NAME_CHARS = 120


class ProfileDropped(RuntimeError):
    pass


def _merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _deepest(intervals, points):
    """For each point, in ascending order, the name of the latest-started
    interval that holds it (the deepest of properly nested ones), or None."""
    order = sorted(intervals, key=lambda x: (x[1], -x[2]))
    names, k, stack = [], 0, []
    for t in points:
        while k < len(order) and order[k][1] <= t:
            name, s, e = order[k]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((name, e))
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][0] if stack else None)
    return names


def matches(key, name):
    return re.search(rf"\b{re.escape(key)}\b", name) is not None


def profile_calls(torch, run, keys=(), host=False):
    """Profile ``run()`` (which makes the calls) and read it, with the host's
    activity where ``host``; retried while the profile lacks any device
    record or a kernel named in ``keys``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(0.1)  # records of the first launches in a session have been lost
            run()
            torch.cuda.synchronize()
        got = read_events(torch, prof.profiler.kineto_results.events())
        if got["device"] and all(any(matches(k, n) for n, _, _ in got["device"]) for k in keys):
            return got
        time.sleep(1.0)
    raise ProfileDropped(f"no profile in {TRIES} caught the device records of {list(keys)}")


def read_events(torch, events):
    """Device records, call spans, stage ranges and host operations of one
    profile. A range shows twice, on the host and drawn on the device under
    the same name; no kernel, copy or set bears the name of a host event, so
    a name on both sides marks a range."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.start_ns(), e.end_ns(), e.device_type() == cuda,
               e.is_user_annotation(), e.start_thread_id()) for e in events]
    host_names = {name for name, _, _, on_device, _, _ in events if not on_device}
    device_names = {name for name, _, _, on_device, _, _ in events if on_device}
    ranges_named = (host_names & device_names) | {CALL}
    device, calls, ranges, ops = [], [], [], []
    main = None
    for name, s, t, on_device, annotation, thread in events:
        if on_device:
            if name not in ranges_named:  # kernels, copies, sets
                device.append((name, s, t))
        elif name == CALL:
            calls.append((s, t))
            main = thread
        elif annotation or name in ranges_named:
            ranges.append((name, s, t, thread))
        else:
            ops.append((name, s, t, thread))
    # the caller's thread only: host activity on other threads does not pace it
    ranges = [(n, s, t) for n, s, t, th in ranges if th == main]
    ops = [(n, s, t) for n, s, t, th in ops if th == main]
    return {"device": device, "calls": sorted(calls), "ranges": ranges, "ops": ops}


def device_time(got):
    """Busy ns (the union of every device interval) and kernel ns and
    launches by name."""
    busy = sum(e - s for s, e in _merge((s, e) for _, s, e in got["device"]))
    kernels, launches = defaultdict(int), defaultdict(int)
    for name, s, e in got["device"]:
        kernels[name] += e - s
        launches[name] += 1
    return {"busy_ns": busy, "kernels": dict(kernels), "launches": dict(launches)}


def idle_gaps(got):
    """The device's idle ns inside the calls, by what the host was doing
    (stage: operation)."""
    calls = got["calls"]
    busy_iv = _merge((s, e) for _, s, e in got["device"])
    gaps = []
    starts = [s for s, _ in busy_iv]
    for c0, c1 in calls:
        k = max(bisect.bisect_right(starts, c0) - 1, 0)
        t = c0
        while k < len(busy_iv) and busy_iv[k][0] < c1:
            s, e = max(busy_iv[k][0], c0), min(busy_iv[k][1], c1)
            if e > s:
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
            k += 1
        if c1 > t:
            gaps.append((t, c1))
    mids = [(s + e) / 2 for s, e in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    stages = _deepest(got["ranges"], [mids[i] for i in order])
    hosts = _deepest(got["ops"], [mids[i] for i in order])
    idle = defaultdict(int)
    for i, stage, host in zip(order, stages, hosts):
        s, e = gaps[i]
        idle[f"{stage or 'driver'}: {host or 'python'}"[:NAME_CHARS]] += e - s
    return dict(idle)


def top(ns_by_name, count=10):
    """[[name, seconds], ...] of the largest ``count``."""
    best = sorted(ns_by_name.items(), key=lambda x: -x[1])[:count]
    return [[name[:NAME_CHARS], ns / 1e9] for name, ns in best]
