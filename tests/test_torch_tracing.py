"""The port's spans and counters (eigensolver_gpu_torch/utils/tracing.py) on the CPU:
span records, the timings' contract, the cost of tracing off, host-sync counting
through the warnings hook, and the spans and counters placed in the drivers, in
stedc and in the refinement."""

import collections
import importlib
import time
import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.ops import refine
from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
from eigensolver_gpu_torch.ops.stedc import stedc
from eigensolver_gpu_torch.utils import tracing
from eigensolver_gpu_torch.utils.testing import random_hpd_pair, random_spd_pair

t_sygvdx = importlib.import_module("eigensolver_gpu_torch.models.sygvdx")
t_planar = importlib.import_module("eigensolver_gpu_torch.models.zhegvdx_planar")


@pytest.fixture
def traced():
    """Tracing on (sync mode, as the benchmark's staged calls), off afterwards."""
    tracing.clear()
    tracing.enable(sync=True)
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.clear()


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s["name"]].append(s)
    return out


def test_span_records_nest_count_and_follow_calls(traced):
    with tracing.trace_range("outer"):
        tracing.count("work")
        with tracing.trace_range("inner"):
            tracing.count("work", 2)
            tracing.count("other")
            time.sleep(0.002)
        tracing.count("work", 3)
    tracing.clear()
    with tracing.trace_range("next"):
        pass
    tracing.count("nowhere")  # no span open: dropped
    spans = tracing.export()
    assert [s["name"] for s in spans] == ["outer", "inner", "next"]
    assert [s["id"] for s in spans] == [0, 1, 2]
    outer, inner, nxt = spans
    assert (outer["parent"], inner["parent"], nxt["parent"]) == (None, 0, None)
    assert (outer["call"], inner["call"], nxt["call"]) == (0, 0, 1)
    assert outer["counts"] == {"work": 4} and inner["counts"] == {"work": 2, "other": 1}
    assert nxt["counts"] == {}
    for s in spans:
        assert isinstance(s["start_ns"], int) and s["start_ns"] <= s["end_ns"]
    assert outer["start_ns"] <= inner["start_ns"] and inner["end_ns"] <= outer["end_ns"]
    assert inner["end_ns"] - inner["start_ns"] >= 2_000_000
    assert outer["end_ns"] <= nxt["start_ns"]
    # the clock is the Unix-epoch one of torch.profiler's events
    assert abs(nxt["end_ns"] - time.time_ns()) < 60e9


def test_timings_keep_their_contract():
    """(name, seconds) of each synchronizing range closed since the last clear(),
    in closing order; none without sync mode; clear() drops them."""
    tracing.clear()
    tracing.enable(sync=False)
    try:
        with tracing.trace_range("unsynced"):
            pass
        assert tracing.timings() == []
        tracing.enable(sync=True)
        with tracing.trace_range("a"):
            with tracing.trace_range("b"):
                time.sleep(0.003)
        got = tracing.timings()
        assert [name for name, _ in got] == ["b", "a"]
        assert all(isinstance(s, float) for _, s in got)
        assert got[0][1] >= 0.003 and got[1][1] >= got[0][1]
        tracing.clear()
        assert tracing.timings() == []
    finally:
        tracing.disable()
        tracing.clear()


def test_export_survives_clear_and_disable_and_resets_on_enable():
    tracing.enable()
    try:
        with tracing.trace_range("kept"):
            tracing.count("k")
        tracing.clear()
        tracing.disable()
        assert [(s["name"], s["counts"]) for s in tracing.export()] == [("kept", {"k": 1})]
        tracing.export()[0]["counts"]["k"] = 99  # a copy
        assert tracing.export()[0]["counts"] == {"k": 1}
        tracing.enable()
        assert tracing.export() == []
        with tracing.trace_range("fresh"):
            pass
        assert [(s["name"], s["id"], s["call"]) for s in tracing.export()] == [("fresh", 0, 0)]
    finally:
        tracing.disable()
        tracing.clear()


def test_records_keep_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "_spans", collections.deque(maxlen=3))
    tracing.enable()
    try:
        for k in range(5):
            with tracing.trace_range(f"r{k}"):
                pass
    finally:
        tracing.disable()
    assert [(s["name"], s["id"]) for s in tracing.export()] == [("r2", 2), ("r3", 3), ("r4", 4)]


def test_a_range_that_raises_leaves_no_record_and_closes():
    tracing.enable(sync=True)
    try:
        with pytest.raises(ValueError):
            with tracing.trace_range("raises"):
                raise ValueError("inside")
        with tracing.trace_range("after"):
            pass
    finally:
        tracing.disable()
        tracing.clear()
    spans = tracing.export()
    assert [(s["name"], s["parent"]) for s in spans] == [("after", None)]


class _Untouchable:
    """Stands for a module that tracing off must not reach."""

    def __getattr__(self, name):
        raise AssertionError(f"tracing off touched {name!r}")


def test_tracing_off_is_one_flag_test(monkeypatch):
    """Off, trace_range and count reach neither torch (record_function, NVTX,
    the sync debug mode, synchronize) nor the clock, and record nothing."""
    tracing.enable()
    with tracing.trace_range("before"):
        pass
    tracing.disable()
    before, timings = tracing.export(), tracing.timings()
    filters, show = list(warnings.filters), warnings.showwarning
    monkeypatch.setattr(tracing, "torch", _Untouchable())
    monkeypatch.setattr(tracing, "time", _Untouchable())
    for _ in range(3):
        with tracing.trace_range("off"):
            tracing.count("off")
            with tracing.trace_range("off_inner"):
                tracing.count("off", 5)
    monkeypatch.undo()
    assert tracing.export() == before and tracing.timings() == timings
    assert warnings.filters == filters and warnings.showwarning is show


def test_host_syncs_are_counted_under_the_innermost_span_only():
    """The warnings hook: a sync warning under a span counts there and is not
    shown; one with no span open, or made by the module's own synchronize, is
    not counted; other warnings reach the previous showwarning; disable()
    restores the filters and showwarning."""
    shown = []
    filters_before = list(warnings.filters)
    show_before = warnings.showwarning
    warnings.showwarning = lambda message, *args, **kw: shown.append(str(message))
    try:
        outside = list(warnings.filters), warnings.showwarning
        tracing.enable()
        try:
            warnings.warn(tracing.SYNC_WARNING + " (outside any span)")
            with tracing.trace_range("outer"):
                with tracing.trace_range("inner"):
                    for _ in range(3):  # the same line: shown 'always', each counted
                        warnings.warn(tracing.SYNC_WARNING + " (Triggered internally)")
                    warnings.warn("another warning")
                warnings.warn(tracing.SYNC_WARNING)
                tracing._own_sync = True
                try:
                    warnings.warn(tracing.SYNC_WARNING + " (the module's own)")
                finally:
                    tracing._own_sync = False
        finally:
            tracing.disable()
        assert (list(warnings.filters), warnings.showwarning) == outside
    finally:
        warnings.showwarning = show_before
    assert warnings.filters == filters_before
    spans = _by_name(tracing.export())
    assert spans["inner"][0]["counts"] == {tracing.HOST_SYNC: 3}
    assert spans["outer"][0]["counts"] == {tracing.HOST_SYNC: 1}
    assert shown == ["another warning"]


def test_enable_twice_hooks_once():
    filters, show = list(warnings.filters), warnings.showwarning
    tracing.enable()
    tracing.enable(sync=True)
    tracing.disable()
    tracing.clear()
    assert warnings.filters == filters and warnings.showwarning is show


def _probe(monkeypatch, module, names):
    """Wrap module.<name> so that each call counts ``probe.<name>`` under the
    span open around it."""
    for name in names:
        real = getattr(module, name)

        def probed(*args, _real=real, _name=name, **kw):
            tracing.count(f"probe.{_name}")
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, probed)


DRIVER_CASES = {
    # name: (the driver's range, a function of each phase by its span)
    "dsygvdx_subst": ("sygvdx", {"potrf": "cholesky_upper", "to_standard": "sygst",
                                 "back_solve": "trsm_phase4"}),
    "dsygvdx_trinv": ("sygvdx", {"potrf": "cholesky_upper", "to_standard": "trinv_upper_full"}),
    "zhegvdx_planar_subst": ("zhegvdx_planar", {"potrf": "pcholesky_lower",
                                                "to_standard": "ptrsm_left_lower_inv",
                                                "back_solve": "ptrsm_left_upper"}),
    "zhegvdx_planar_trinv": ("zhegvdx_planar", {"potrf": "pcholesky_lower",
                                                "to_standard": "ptrinv_lower"}),
}


def _solve(case):
    if case == "dsygvdx_subst":
        a, b = random_spd_pair(64, seed=21)
        return eig.dsygvdx(a, b, il=1, iu=6, device="cpu")
    if case == "dsygvdx_trinv":  # the gate: fp32 and n = 512 * 2^k
        a, b = random_spd_pair(512, seed=22)
        return eig.sygvdx(torch.from_numpy(a).float(), torch.from_numpy(b).float(), il=1, iu=4,
                          cfg=eig.SolverConfig(sygst_mode="trinv", tridiag_mode="two"))
    if case == "zhegvdx_planar_subst":
        a, b = random_hpd_pair(64, seed=23)
        return eig.zhegvdx_planar_host(a, b, il=1, iu=6, device="cpu",
                                       cfg=eig.SolverConfig(compute_dtype="float32"))
    a, b = random_hpd_pair(128, seed=24)  # the gate: fp32 and n = 128 * 2^k
    return eig.zhegvdx_planar_host(a.astype(np.complex64), b.astype(np.complex64), il=1, iu=4,
                                   device="cpu", cfg=eig.SolverConfig(planar_solve_mode="trinv"))


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_driver_phases_open_once_each_in_order(monkeypatch, traced, case):
    """potrf, to_standard and back_solve open once each, in that order, as
    children of the driver's range and of no other span; each phase's
    function runs under its own span (the 'trinv' routes: the inverse under
    to_standard)."""
    driver, probes = DRIVER_CASES[case]
    module = t_sygvdx if driver == "sygvdx" else t_planar
    _probe(monkeypatch, module, probes.values())
    res = _solve(case)
    assert int(res.info) == 0
    spans = tracing.export()
    by = _by_name(spans)
    assert len(by[driver]) == 1, [s["name"] for s in spans]
    top = by[driver][0]["id"]
    phases = [by[name] for name in ("potrf", "to_standard", "back_solve")]
    assert [len(p) for p in phases] == [1, 1, 1]
    potrf, to_std, back = (p[0] for p in phases)
    assert potrf["parent"] == to_std["parent"] == back["parent"] == top
    assert potrf["end_ns"] <= to_std["start_ns"] and to_std["end_ns"] <= back["start_ns"]
    assert potrf["id"] < to_std["id"] < back["id"]
    for span_name, fn in probes.items():
        assert by[span_name][0]["counts"].get(f"probe.{fn}") >= 1, (span_name, fn)
    names = [name for name, _ in tracing.timings()]
    assert [names.count(x) for x in ("potrf", "to_standard", "back_solve")] == [1, 1, 1]
    assert not any(name.startswith("sygst") for name in names)


def test_stedc_leaves_open_once_inside_stedc(traced):
    rng = np.random.default_rng(5)
    d, e = torch.from_numpy(rng.standard_normal(200)), torch.from_numpy(rng.standard_normal(199))
    stedc(d, e, leaf=32)
    by = _by_name(tracing.export())
    assert len(by["stedc"]) == 1 and len(by["stedc_leaves"]) == 1
    assert by["stedc_leaves"][0]["parent"] == by["stedc"][0]["id"]


def _perturbed(pair, seed):
    """The exact generalized eigenbasis rounded to fp32 and perturbed at the
    1e-5 level, with perturbed w (what an fp32 pipeline hands over)."""
    a, b = pair
    w, z = scipy.linalg.eigh(a, b)
    rng = np.random.default_rng(seed)
    z32 = np.complex64 if np.iscomplexobj(z) else np.float32
    return ((z + 1e-5 * rng.standard_normal(z.shape)).astype(z32).astype(z.dtype),
            w + 1e-5 * rng.standard_normal(w.shape))


def _count_sweeps(monkeypatch, module):
    calls = []
    real = module._sweep

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "_sweep", counted)
    return calls


@pytest.mark.parametrize("planar, sweeps", [(False, 0), (False, 1), (True, 1)])
def test_refine_extra_sweeps_counts_the_escalation(monkeypatch, traced, planar, sweeps):
    """A basis perturbed at 1e-5 and one fp64 sweep (or, real, none: the
    first escalation sweep measures the defect) escalates: the counter under
    the refinement's range equals the sweeps run beyond the static ones."""
    from eigensolver_gpu_torch.ops import refine_planar

    n, sel = 48, (8, 16)
    pair = (random_hpd_pair if planar else random_spd_pair)(n, seed=93)
    z, w0 = _perturbed(pair, 94)
    a, b = pair
    kw = dict(sweeps=sweeps, coarse_first=False, sel=sel, extra_max=3, w0=torch.from_numpy(w0))
    calls = _count_sweeps(monkeypatch, refine_planar if planar else refine)
    if planar:
        T = torch.from_numpy
        refine_gevp_planar((T(a.real), T(a.imag)), (T(b.real), T(b.imag)),
                           (T(z.real.copy()), T(z.imag.copy())), **kw)
        name = "refine_gevp_planar"
    else:
        refine.refine_gevp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(z), **kw)
        name = "refine_gevp"
    (span,) = _by_name(tracing.export())[name]
    extra = span["counts"].get("refine_extra_sweeps", 0)
    assert extra >= 1 and extra == len(calls) - sweeps
