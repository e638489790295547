"""device_idle_pct: 100 x (1 - the device's busy time over the wall time of the same
calls), of the calls profiled with CUDA activity alone: busy is the union of their
kernel, copy and set intervals, wall the sum of their spans on the host's clock (the
``busy_s`` and ``window_s`` of the result's ``device``). The profiler's tracing of
each launch slows the host, so the share reads above that of an unprofiled call;
``device_busy_ms`` is the device's own, steadier reading."""


def read(rec):
    prof = rec["profile"]
    if not prof or not prof["window_ns"]:
        return None
    return 100.0 * (1.0 - prof["busy_ns"] / prof["window_ns"])
