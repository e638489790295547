"""On the card, the program's spans and host-sync counter (``python -m pytest
port_bench/tests -m cuda``): a span's start and end lie within 50 us of its range's
kineto user annotation (one clock); the ``host_sync`` count of a traced call equals
the sync warnings of the same call under ``set_sync_debug_mode("warn")`` with tracing
off; ``disable()`` restores the debug mode and the warning filters."""

import collections
import warnings

import pytest

from port_bench import spec

N, IU = 512, 64  # a small solve of each configuration: every stage, every kind of sync
CONFIGS = ["zhegvdx_mp", "dsygvdx_mp"]
TOL_NS = 50_000


@pytest.fixture
def torch():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch


def _solver(torch, config_name):
    """One warmed-up call of the configuration's single entry at N: call()."""
    from eigensolver_gpu_torch.utils.config import SolverConfig

    from port_bench import harness

    config = spec._json(spec.HERE / "configs" / f"{config_name}.json")
    harness.build(config["build"])
    entry = harness.resolve(config["entries"]["single"])
    gen = "hpd_planar" if config["input"] == "planar" else "spd_real"
    (problem,) = spec.module("inputs", gen).make(N, 1, 1, 2**31 + 11, "cuda")
    cfg = SolverConfig(**config["solver"])

    def call():
        return entry(*problem, il=1, iu=IU, cfg=cfg)

    call()
    torch.cuda.synchronize()
    return call


def _worst_distance(torch, call, sync):
    """One call profiled with tracing on: the largest distance between a span's
    start or end and its range's kineto user annotation, with that span's name."""
    from torch.profiler import ProfilerActivity, profile

    from eigensolver_gpu_torch.utils import tracing

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracing.enable(sync=sync)
        try:
            call()
            torch.cuda.synchronize()
        finally:
            tracing.disable()
            tracing.clear()
    spans = collections.defaultdict(list)
    for s in tracing.export():
        spans[s["name"]].append((s["start_ns"], s["end_ns"]))
    marks = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda and e.is_user_annotation() and e.name() in spans:
            marks[e.name()].append((e.start_ns(), e.end_ns()))
    assert {"zhegvdx_planar", "potrf", "stedc_leaves", "back_solve"} <= set(spans)
    worst = (0, None)
    for name, got in spans.items():
        assert len(marks[name]) == len(got), name
        for (s0, s1), (k0, k1) in zip(sorted(got), sorted(marks[name])):
            worst = max(worst, (abs(s0 - k0), name), (abs(s1 - k1), name))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("sync", [False, True])
def test_spans_share_the_profilers_clock(torch, sync):
    """Every span of a profiled call within 50 us of its annotation. A clock
    other than the profiler's would miss in every call; a stall of the host
    inside one range's enter or exit (a collection, a profiler buffer) misses
    in one, so the call is profiled up to three times."""
    call = _solver(torch, "zhegvdx_mp")
    tries = []
    for _ in range(3):
        tries.append(_worst_distance(torch, call, sync))
        if tries[-1][0] <= TOL_NS:
            break
    print("largest span-annotation distance a profiled call: "
          + ", ".join(f"{d / 1e3:.1f} us ({name})" for d, name in tries))
    assert tries[-1][0] <= TOL_NS


@pytest.mark.cuda
@pytest.mark.parametrize("config_name", CONFIGS)
def test_host_sync_count_matches_the_debug_mode(torch, config_name):
    """The traced call's host_sync counts (its spans, under one outer span so
    that none falls outside) against the warnings of the same call under the
    debug mode with tracing off."""
    from eigensolver_gpu_torch.utils import tracing

    call = _solver(torch, config_name)
    tracing.enable(sync=False)
    try:
        with tracing.trace_range("call"):
            call()
        torch.cuda.synchronize()
    finally:
        tracing.disable()
        tracing.clear()
    by_span = collections.Counter()
    for s in tracing.export():
        by_span[s["name"]] += s["counts"].get(tracing.HOST_SYNC, 0)
    counted = sum(by_span.values())

    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    warned = sum(str(w.message).startswith(tracing.SYNC_WARNING) for w in caught)
    print(f"{config_name} n {N}: host_sync {counted}, debug-mode warnings {warned}; by span "
          + ", ".join(f"{k} {v}" for k, v in by_span.most_common() if v))
    assert counted == warned > 0


@pytest.mark.cuda
@pytest.mark.parametrize("prior", [0, "warn"])
def test_disable_restores_debug_mode_and_filters(torch, prior):
    from eigensolver_gpu_torch.utils import tracing

    torch.cuda.set_sync_debug_mode(prior)
    try:
        mode = torch.cuda.get_sync_debug_mode()
        filters, show = list(warnings.filters), warnings.showwarning
        tracing.enable(sync=True)
        assert torch.cuda.get_sync_debug_mode() == 1
        tracing.enable()
        tracing.disable()
        tracing.clear()
        assert torch.cuda.get_sync_debug_mode() == mode
        assert warnings.filters == filters and warnings.showwarning is show
    finally:
        torch.cuda.set_sync_debug_mode(0)
