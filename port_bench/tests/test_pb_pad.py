"""The readers of the planar driver's padding (``pad_ms`` ← span ``pad_pencil``,
``pad_rows`` ← counter ``pad.rows``) against hand-made records and exports: the number
where the run has the span or the counter, None where it has not."""

import importlib

import pytest

from port_bench import spec

TRACING = "eigensolver_gpu_torch.utils.tracing"
CELL = "zhegvdx_mp_ausurf112.kp2_n1478_iu739"


def _rec(calls):
    return {"staged": [{"seconds": sum(s for _, s in c), "ranges": c, "sweeps": []}
                       for c in calls]}


def _span(i, name, call, counts, parent=None):
    return {"id": i, "name": name, "start_ns": 10 * i, "end_ns": 10 * i + 5, "parent": parent,
            "call": call, "counts": counts}


def test_pad_ms_sums_the_spans_of_a_call_then_takes_the_mean():
    rec = _rec([[("zhegvdx_planar", 1.0), ("pad_pencil", 0.003), ("potrf", 0.01),
                 ("pad_pencil", 0.001), ("pad_pencil", 0.002)],
                [("pad_pencil", 0.004), ("zhegvdx_planar", 1.0)]])
    assert spec.reader("pad_ms")(rec) == pytest.approx(1e3 * (0.006 + 0.004) / 2)


def test_pad_ms_reads_nothing_without_the_span():
    """An aligned n, or the parent program: no pad_pencil range."""
    assert spec.reader("pad_ms")(_rec([[("zhegvdx_planar", 1.0), ("potrf", 0.01)]])) is None
    assert spec.reader("pad_ms")(_rec([])) is None


def test_pad_rows_counts_per_call(monkeypatch):
    spans = [_span(0, "zhegvdx_planar", 1, {}), _span(1, "pad_pencil", 1, {"pad.rows": 58}, 0),
             _span(2, "potrf", 1, {"host_sync": 1}, 0),
             _span(3, "zhegvdx_planar", 2, {}), _span(4, "pad_pencil", 2, {"pad.rows": 58}, 3)]
    monkeypatch.setattr(importlib.import_module(TRACING), "export", lambda: spans)
    rec = _rec([[("zhegvdx_planar", 1.0)], [("zhegvdx_planar", 1.0)]])
    assert spec.reader("pad_rows")(rec) == pytest.approx(58.0)


@pytest.mark.parametrize("case", ["no_count", "no_export", "no_calls"])
def test_pad_rows_reads_nothing_without_the_counter(monkeypatch, case):
    tracing = importlib.import_module(TRACING)
    rec = _rec([[("zhegvdx_planar", 1.0)]])
    if case == "no_count":
        monkeypatch.setattr(tracing, "export",
                            lambda: [_span(0, "zhegvdx_planar", 1, {"host_sync": 3})])
    elif case == "no_export":
        monkeypatch.delattr(tracing, "export")
    else:
        rec = _rec([])
    assert spec.reader("pad_rows")(rec) is None


def test_the_cell_reports_the_two_and_they_list_only_it():
    """pad_ms and pad_rows list the AUSURF112 cell alone; the cell reports every
    per-layer metric."""
    bench = spec.benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in ("pad_ms", "pad_rows")}
    assert set(got) == {"pad_ms", "pad_rows"}
    for m in got.values():
        assert m["workloads"] == [CELL] and m["moves"] == "solve_ms"
        assert m["layer"] == "drivers and standard form" and m["better"] == "lower"
    assert got["pad_ms"]["source"] == "program_span"
    assert got["pad_rows"]["source"] == "program_counter"
    cell = spec.cell(CELL)
    assert {"pad_ms", "pad_rows"} <= {m["name"] for m in cell.per_layer}
    # the cell runs every stage: each accepted per-layer metric lists it too
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in bench["per_layer"]]
    wl = cell.workload
    assert (wl["n"], wl["il"], wl["iu"], wl["batch"], wl["pool"]) == (1478, 1, 739, 2, 8)
    assert wl["n"] % 128 != 0 and cell.config["reduced"] == []
