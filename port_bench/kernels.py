"""Kernel times of the profiled calls and their shares of the roofline."""

from __future__ import annotations

from port_bench import trace, work


def seconds_per_call(rec, role):
    """Device seconds a profiled call of the configuration's kernel ``role``
    ('chase', 'replay'); None without a profile or a launch of it."""
    prof = rec["profile"]
    key = rec["config"]["kernels"].get(role)
    if not prof or not key:
        return None
    ns = sum(t for name, t in prof["kernels"].items() if trace.matches(key, name))
    return ns / 1e9 / prof["calls"] if ns else None


def roofline_pct(rec, role):
    """100 x the least time ``work.py`` allows the kernel over its time."""
    measured = seconds_per_call(rec, role)
    if measured is None:
        return None
    return 100.0 * work.kernel_seconds(role, rec["cell"], rec["config"]) / measured
