"""The harness driven by data, on the CPU: a new configuration, cell and metric are
new files only; the result line's keys; no card, no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NEW = "zhegvdx_tiny.n128_iu16"
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]

CHILD = """
import json, sys, time
t = time.perf_counter()
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from port_bench import harness, spec
result, _ = harness.run_cell(spec.cell(sys.argv[3]), 2**31 + 99, 0.01, sys.argv[4] == "1",
                             "cpu", t)
print(json.dumps(result))
"""


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and port_bench/, then one configuration, one cell
    and one metric added as new files and entries."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "zhegvdx_mp.json").read_text())
    cfg.update(name="zhegvdx_tiny", solver=dict(cfg["solver"], refine_iters=3))
    (pb / "configs" / "zhegvdx_tiny.json").write_text(json.dumps(cfg))
    limits = json.loads((pb / "workloads" / "zhegvdx_mp.n4096_iu1024.json").read_text())["limits"]
    why = "a tiny planar cell that the harness finds by its files alone"
    wl = {"name": NEW, "config": "zhegvdx_tiny", "traffic": "n128_iu16", "chips": 1, "n": 128,
          "il": 1, "iu": 16, "batch": 1, "inputs": "hpd_planar", "pool": 2, "why": why,
          "limits": limits}
    (pb / "workloads" / f"{NEW}.json").write_text(json.dumps(wl))
    (pb / "metrics" / "calls_counted.py").write_text(
        '"""calls_counted: calls of the window."""\n\n\ndef read(rec):\n'
        '    return float(len(rec["calls_s"]))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "zhegvdx_tiny", "source": cfg["source"],
                             "file": "port_bench/configs/zhegvdx_tiny.json", "reduced": [],
                             "why": why})
    bench["workloads"].append({k: wl[k] for k in ("name", "config", "traffic", "chips", "why")})
    bench["per_layer"].append({"name": "calls_counted", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "drivers and standard form",
                               "moves": "solve_ms", "workloads": [NEW]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items() if p.name != "BENCHMARK.json")
    return root


def _run(root, trace):
    out = subprocess.run([sys.executable, "-c", CHILD, str(root), str(ROOT), NEW, str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_new_files_resolve_and_line_keys(checkout, trace):
    result, err = _run(checkout, trace)
    assert list(result) == KEYS
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    if trace:
        # the other per-layer metrics list their cells, and this one is not among them
        assert result["metrics"] == {"calls_counted": {"value": result["attempted"],
                                                       "unit": "calls"}}
    else:
        assert set(result["metrics"]) == {"solve_ms", "solve_ms_p90", "setup_s"}
    assert list(result["check"]) == ["info_bad", "eig_err", "residual", "b_orth"]
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())


def _cli(root, env):
    return subprocess.run([sys.executable, str(root / "port_bench" / "run.py"), "--workload",
                           NEW, "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=root, env=env)


def test_no_card_no_result(checkout):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = _cli(checkout, env)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_without_the_program_no_result(checkout):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(checkout, dict(env, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    sys.path.insert(0, str(HERE))
    try:
        import run
    finally:
        sys.path.remove(str(HERE))
    monkeypatch.setitem(sys.modules, "eigensolver_gpu_tpu_like", object())
    assert "eigensolver_gpu_tpu_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
