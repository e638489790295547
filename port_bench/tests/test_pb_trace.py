"""trace.py's reading of kineto records, on made-up records."""

import types

import torch

from port_bench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def event(name, s, e, device=CPU, kind="cpu_op", thread=1):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: s, end_ns=lambda: e, device_type=lambda: device,
        is_user_annotation=lambda: kind == "user_annotation", start_thread_id=lambda: thread)


def test_busy_kernels_and_gaps():
    events = [
        event(trace.CALL, 0, 100, kind="user_annotation"),
        event(trace.CALL, 0, 100, device=CUDA, kind="gpu_user_annotation"),
        event("stedc", 10, 90, kind="range"),  # a range, though not flagged as one
        event("aten::item", 40, 60),
        event("aten::mm", 70, 75),
        event("aten::add", 20, 30, thread=2),  # another thread: not the caller's
        event("stedc", 0, 100, device=CUDA, kind="gpu_user_annotation"),  # not device work
        event("k1", 0, 30, device=CUDA, kind="kernel"),
        event("k1", 20, 35, device=CUDA, kind="kernel"),
        event("copy", 65, 80, device=CUDA, kind="gpu_memcpy"),
    ]
    got = trace.read_events(torch, events)
    dev = trace.device_time(got)
    assert dev["busy_ns"] == 35 + 15
    assert dev["kernels"] == {"k1": 45, "copy": 15} and dev["launches"]["k1"] == 2
    gaps = trace.idle_gaps(got)
    # 35..65 (mid 50: inside aten::item under stedc), 80..100 (mid 90: stedc's end)
    assert gaps == {"stedc: aten::item": 30, "stedc: python": 20}
    assert trace.top(gaps, 1) == [["stedc: aten::item", 30e-9]]


def test_matches_whole_names():
    assert trace.matches("chase_kernel", "void (anonymous namespace)::chase_kernel<float>(float*)")
    assert not trace.matches("chase_kernel", "void chase_planar_kernel<float>(float*)")
    assert not trace.matches("replay_kernel", "replay_planar_kernel<double>")
