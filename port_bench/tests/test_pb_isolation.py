"""What the benchmark may import and read, and the layout BENCHMARK.json promises."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]  # port_bench/
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "eigensolver_gpu_tpu"}
PROGRAM = "eigensolver_gpu_torch"


def _sources(*parts):
    base = HERE.joinpath(*parts)
    return sorted(base.rglob("*.py")) if base.is_dir() else [base]


def top_level_imports(path, strings=True):
    """Top-level names of every import and, with ``strings``, of every dotted
    name in a string (what importlib.import_module is handed)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif strings and isinstance(node, ast.Constant) and isinstance(node.value, str):
            if re.fullmatch(r"[A-Za-z_][\w]*(\.[A-Za-z_]\w*)+", node.value):
                names.add(node.value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    # whole top-level names: the port's own name begins with the JAX package's prefix
    for path in _sources():
        strings = "tests" not in path.relative_to(HERE).parts  # the tests name modules to fake
        assert not top_level_imports(path, strings) & FORBIDDEN, path
    for path in HERE.rglob("*.json"):
        text = path.read_text()
        for name in FORBIDDEN:
            assert not re.search(rf"(?<![\w.]){name}(?![\w])", text), (path, name)


def test_whole_name_comparison():
    assert "eigensolver_gpu_torch" not in FORBIDDEN
    assert top_level_imports.__doc__


@pytest.mark.parametrize("part", ["reference.py", "check.py", "control.py", "work.py", "inputs"])
def test_yardstick_imports_nothing_of_the_program(part):
    for path in _sources(part):
        assert PROGRAM not in top_level_imports(path), path


def test_nothing_reads_the_jax_benchmark():
    # the JAX package's bench.py and benchmarks/ stay as they are, unread
    words = re.compile(r"\bbench\.py\b|\bbenchmarks/")
    for path in [p for p in HERE.rglob("*") if p.is_file() and "tests" not in p.parts
                 and "__pycache__" not in p.parts and ".cache" not in p.parts]:
        assert not words.search(path.read_text()), path


def test_every_name_resolves_to_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["port_bench"]
    assert bench["command"] == ["python3", "port_bench/run.py"]
    for c in bench["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
    for w in bench["workloads"]:
        wl = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert {k: wl[k] for k in ("name", "config", "traffic", "chips", "why")} == w
        assert (HERE / "inputs" / f"{wl['inputs']}.py").is_file()
        assert set(wl["limits"]) == {"info_bad", "eig_err", "residual", "b_orth"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", m["name"])
    assert {m["name"] for m in bench["end_to_end"]} == {
        "solve_ms", "solve_ms_p90", "peak_mem_gib", "setup_s"}
    for m in bench["per_layer"]:
        assert m["moves"] == "solve_ms"
    cells = len(bench["workloads"])
    assert cells >= 1 and all(w["chips"] == 1 for w in bench["workloads"])
    # a full check with 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_card_tests_decide_inside_the_test():
    # no test module asks for the card while it is imported
    for path in (HERE / "tests").glob("test_*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
                continue  # the docstring
            assert "cuda" not in ast.unparse(node), (path, ast.unparse(node))
