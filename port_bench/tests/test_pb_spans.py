"""The readers of the program's spans and counters (``spans.py``, ``cholesky_ms``,
``standard_form_ms``, ``upper_solve_ms``, ``stedc_leaf_ms``, ``host_syncs``,
``refine_extra_sweeps``) against hand-made records and exports, and one traced run of a
tiny cell on the CPU that reports them."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import spec

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
TRACING = "eigensolver_gpu_torch.utils.tracing"
SPANS = {"cholesky_ms": "potrf", "standard_form_ms": "to_standard",
         "upper_solve_ms": "back_solve", "stedc_leaf_ms": "stedc_leaves"}
COUNTERS = {"host_syncs": "host_sync", "refine_extra_sweeps": "refine_extra_sweeps"}
NEW = list(SPANS) + list(COUNTERS)


def _rec(calls):
    return {"staged": [{"seconds": sum(s for _, s in c), "ranges": c, "sweeps": []}
                       for c in calls]}


def _span(i, name, call, counts, parent=None):
    return {"id": i, "name": name, "start_ns": 10 * i, "end_ns": 10 * i + 5, "parent": parent,
            "call": call, "counts": counts}


@pytest.mark.parametrize("metric", list(SPANS))
def test_span_readers_take_the_mean_over_calls(metric):
    name = SPANS[metric]
    rec = _rec([[("zhegvdx_planar", 1.0), (name, 0.010), ("stedc", 0.4)],
                [(name, 0.020), (name, 0.002), ("zhegvdx_planar", 1.0)],
                [("zhegvdx_planar", 1.0)]])
    assert spec.reader(metric)(rec) == pytest.approx(1e3 * (0.010 + 0.022 + 0.0) / 3)


@pytest.mark.parametrize("metric", list(SPANS))
def test_span_readers_read_nothing_without_the_span(metric):
    """The parent program has no such range: the reader gives None, as it does
    for a run without staged calls."""
    assert spec.reader(metric)(_rec([[("zhegvdx_planar", 1.0), ("stedc", 0.4)]])) is None
    assert spec.reader(metric)(_rec([])) is None


@pytest.mark.parametrize("metric", list(COUNTERS))
def test_counter_readers_sum_the_export_per_call(monkeypatch, metric):
    import importlib

    name = COUNTERS[metric]
    spans = [_span(0, "zhegvdx_planar", 1, {}), _span(1, "stedc", 1, {name: 40, "x": 3}, 0),
             _span(2, "refine_gevp_planar", 1, {name: 2}, 0),
             _span(3, "zhegvdx_planar", 2, {name: 1}),
             _span(4, "stedc", 2, {name: 37}, 3)]
    monkeypatch.setattr(importlib.import_module(TRACING), "export", lambda: spans)
    rec = _rec([[("zhegvdx_planar", 1.0)], [("zhegvdx_planar", 1.0)]])
    assert spec.reader(metric)(rec) == pytest.approx((40 + 2 + 1 + 37) / 2)
    monkeypatch.setattr(importlib.import_module(TRACING), "export", lambda: spans[:1])
    assert spec.reader(metric)(rec) == 0.0
    assert spec.reader(metric)(_rec([])) is None


@pytest.mark.parametrize("metric", list(COUNTERS))
def test_counter_readers_read_nothing_from_a_program_without_export(monkeypatch, metric):
    import importlib

    monkeypatch.delattr(importlib.import_module(TRACING), "export")
    assert spec.reader(metric)(_rec([[("zhegvdx_planar", 1.0)]])) is None


def test_the_six_entries_are_appended_for_the_accepted_cells():
    bench = spec.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    got = {m["name"]: m for m in bench["per_layer"][-len(NEW):]}
    assert list(got) == NEW
    for name, m in got.items():
        assert m["moves"] == "solve_ms" and m["workloads"] == cells and m["better"] == "lower"
        assert m["source"] == ("program_span" if name in SPANS else "program_counter")
    layers = {m["layer"] for m in bench["per_layer"][:-len(NEW)]}
    assert {m["layer"] for m in got.values()} <= layers


CELL = "zhegvdx_tiny_spans.n128_iu16"
CHILD = """
import json, sys, time
t = time.perf_counter()
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from port_bench import harness, spec
result, _ = harness.run_cell(spec.cell(sys.argv[3]), 2**31 + 77, 0.5, True, "cpu", t)
print(json.dumps(result))
"""


def test_a_traced_cpu_run_reports_the_six(tmp_path):
    """A tiny planar cell listed in the six entries and in driver_other_ms: its
    traced line has all seven, the three driver spans within driver_other_ms,
    and no host syncs (no CUDA here)."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "zhegvdx_mp.json").read_text())
    cfg.update(name="zhegvdx_tiny_spans", solver=dict(cfg["solver"], refine_iters=3))
    (pb / "configs" / "zhegvdx_tiny_spans.json").write_text(json.dumps(cfg))
    limits = json.loads((pb / "workloads" / "zhegvdx_mp.n4096_iu1024.json").read_text())["limits"]
    why = "a tiny planar cell for the span readers"
    wl = {"name": CELL, "config": "zhegvdx_tiny_spans", "traffic": "n128_iu16", "chips": 1,
          "n": 128, "il": 1, "iu": 16, "batch": 1, "inputs": "hpd_planar", "pool": 2,
          "why": why, "limits": limits}
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": f"port_bench/configs/{cfg['name']}.json", "reduced": [],
                             "why": why})
    bench["workloads"].append({k: wl[k] for k in ("name", "config", "traffic", "chips", "why")})
    for m in bench["per_layer"]:
        if m["name"] in NEW + ["driver_other_ms"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", CHILD, str(root), str(ROOT), CELL],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == set(NEW) | {"driver_other_ms"}, got
    assert all(got[m] > 0 for m in SPANS)
    assert got["cholesky_ms"] + got["standard_form_ms"] + got["upper_solve_ms"] \
        <= got["driver_other_ms"]
    assert got["host_syncs"] == 0.0 and got["refine_extra_sweeps"] >= 0.0
    assert result["metrics"]["host_syncs"]["unit"] == "syncs"
