"""The port's scaffolding: configuration parity with the JAX package,
state conversion, the precision policy, the kernel loader's refusal to
fall back, its test fixtures, and the rule that the port imports
nothing of JAX or of the JAX package."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu.utils import config as jax_config
from eigensolver_gpu_tpu.utils import testing as jax_testing
from eigensolver_gpu_torch.utils import kernel_guard, testing
from eigensolver_gpu_torch.utils.config import SolverConfig
from eigensolver_gpu_torch.utils.convert import config_from_jax_fields, planar_from_numpy
from eigensolver_gpu_torch.utils.precision import highest_precision, true_fp32

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_config_fields_and_defaults_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(SolverConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jax_config.SolverConfig)]
    assert ours == theirs


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"compute_dtype": "float32", "use_pallas": True, "refine_iters": 3},
     {"stedc_backend": "xla", "nb_tridiag": 64, "mosaic_kernels": False}],
)
def test_config_from_jax_fields_round_trips(kwargs):
    jcfg = jax_config.SolverConfig(**kwargs)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    assert cfg == SolverConfig(**kwargs)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_config_checks_match_jax():
    for bad in ({"planar_solve_mode": "x"}, {"stedc_backend": "x"}, {"sygst_mode": "x"},
                {"tridiag_mode": "x"}, {"nb_back": 0}, {"band": 1}):
        with pytest.raises(ValueError):
            jax_config.SolverConfig(**bad)
        with pytest.raises(ValueError):
            SolverConfig(**bad)
    with pytest.raises(ValueError):
        config_from_jax_fields({"nb_back": 128})


def test_planar_from_numpy_splits_contiguous_planes():
    a, b = testing.random_hpd_pair(16, seed=1)
    ar, ai, br, bi = planar_from_numpy(a, b, device="cpu", dtype=torch.float64)
    for t, want in ((ar, a.real), (ai, a.imag), (br, b.real), (bi, b.imag)):
        assert t.is_contiguous() and t.dtype == torch.float64
        assert np.array_equal(t.numpy(), want)
    assert planar_from_numpy(a, b, device="cpu", dtype=torch.float32)[0].dtype == torch.float32


def test_fixtures_and_metrics_match_jax():
    for make in ("random_spd_pair", "random_hpd_pair", "qe_style_pair"):
        for x, y in zip(getattr(testing, make)(24, seed=3), getattr(jax_testing, make)(24, seed=3)):
            assert np.array_equal(x, y)
    a, b = testing.random_hpd_pair(24, seed=4)
    w, z = np.linalg.eigh(a)
    z2 = z * np.exp(1j * np.arange(24))[None, :]
    assert testing.compare_vectors(z2, z) == jax_testing.compare_vectors(z2, z) < 1e-14
    assert testing.ge_residual(a, b, w, z) == jax_testing.ge_residual(a, b, w, z)
    assert testing.orthonormality_error(z) == jax_testing.orthonormality_error(z) < 1e-13


def test_true_fp32_turns_tf32_off_and_restores():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    seen = []

    @highest_precision
    def probe():
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    probe()
    with true_fp32():
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    assert seen == [(False, False), (False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False


def test_loader_raises_without_a_compiler(monkeypatch):
    """No probe, no fallback: a missing nvcc is an error."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(kernel_guard.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(kernel_guard, "BUILD", ROOT / "eigensolver_gpu_torch" / "build" / "absent")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_guard.load("pchol_block")
    assert {p.stem for p in kernel_guard.CSRC.glob("*.cu")} == {
        "chase", "chase_planar", "latrd_panel", "pchol_block", "ql_panel", "ql_panel_planar",
        "replay", "replay_planar", "symv"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


_PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "eigensolver_gpu_torch").rglob("*.py")
) + ["chip_smoke.py", "tools/kernel_ab.py", "tools/kernel_phases.py"]


def test_port_file_list_covers_the_package():
    assert len(_PORT_FILES) > 25
    for name in ("models/sygvdx.py", "models/syevdx.py", "ops/symv.py", "ops/sytrd.py",
                 "ops/refine.py", "utils/kernel_guard.py", "ops/sbrd.py", "ops/sb2st.py",
                 "ops/ql_panel.py", "ops/chase.py", "ops/replay.py", "ops/sbrd_planar.py",
                 "ops/sb2st_planar.py", "models/zhegvdx_planar.py", "utils/roofline.py"):
        assert f"eigensolver_gpu_torch/{name}" in _PORT_FILES


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_imports_neither_jax_nor_the_jax_package(rel):
    """By AST, so imports inside functions count too."""
    for mod in _imports(ROOT / rel):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "eigensolver_gpu_tpu"), f"{rel}: {mod}"


def test_public_exports_cover_the_jax_package_drivers():
    import eigensolver_gpu_tpu
    import eigensolver_gpu_torch

    for name in ("sygvdx", "dsygvdx", "zhegvdx", "syevdx", "SolverConfig", "SygvdxResult",
                 "zhegvdx_planar", "zhegvdx_planar_host", "PlanarResult"):
        assert name in eigensolver_gpu_torch.__all__
        assert callable(getattr(eigensolver_gpu_torch, name))
    for name in ("sygvdx", "dsygvdx", "zhegvdx", "syevdx"):
        assert name in eigensolver_gpu_tpu.__all__
    assert eigensolver_gpu_torch.SygvdxResult._fields == ("w", "z", "info")


# The JAX package's Pallas modules and the port's modules that hold their
# kernels' wrappers (the wrapper keeps the JAX entry's name where the port
# has one).
_PALLAS_TWIN = {"pchol_pallas": "pchol", "latrd_pallas": "latrd", "symv_pallas": "symv",
                "hemv_pallas": "symv", "ql_panel_pallas": "ql_panel", "chase_pallas": "chase",
                "replay_pallas": "replay"}
_INTERPRET = "Pallas interpret mode: a CUDA kernel has none; CPU tensors take the plain version"
_TILE = "the Pallas block shape: the CUDA kernel sizes its own blocks"
_PALLAS_ENTRY = ("the Pallas entry point: its CUDA kernel is called through the wrapper of "
                 "the same module, which builds it or raises")
_AUTO = "the interpreter fallback: the wrapper itself takes the plain version on the CPU"
_MOSAIC = "Mosaic probe: the loader builds the kernel or raises, with no fallback to probe"
# (JAX module, function) or (JAX module, function, argument) -> why the port has no twin
_BY_DESIGN = {
    ("ops/chase_pallas.py", "bulge_chase_pallas"): _PALLAS_ENTRY,
    ("ops/chase_pallas.py", "bulge_chase_planar_pallas"): _PALLAS_ENTRY,
    ("ops/pchol_pallas.py", "pchol_block_planar_pallas"): _PALLAS_ENTRY,
    ("ops/ql_panel_pallas.py", "ql_panel_pallas"): _PALLAS_ENTRY,
    ("ops/ql_panel_pallas.py", "ql_panel_planar_pallas"): _PALLAS_ENTRY,
    ("ops/replay_pallas.py", "apply_q2_pallas"): _PALLAS_ENTRY,
    ("ops/replay_pallas.py", "apply_q2_planar_pallas"): _PALLAS_ENTRY,
    ("ops/hemv_pallas.py", "hemv_planar", "tile"): _TILE,
    ("ops/hemv_pallas.py", "hemv_planar", "interpret"): _INTERPRET,
    ("ops/latrd_pallas.py", "latrd_panel_planar", "tile"): _TILE,
    ("ops/latrd_pallas.py", "latrd_panel_planar", "interpret"): _INTERPRET,
    ("ops/symv_pallas.py", "symv", "tile"): _TILE,
    ("ops/symv_pallas.py", "symv", "interpret"): _INTERPRET,
    ("ops/hemv_pallas.py", "hemv_planar_auto"): _AUTO,
    ("ops/hemv_pallas.py", "hemv_auto"): _AUTO,
    ("ops/symv_pallas.py", "symv_auto"): _AUTO,
    ("utils/kernel_guard.py", "kernel_ok"): _MOSAIC,
    ("utils/kernel_guard.py", "mosaic_backend"): _MOSAIC,
    ("utils/kernel_guard.py", "compiled_unavailable"): _MOSAIC,
}
_JAX_PKG = ROOT / "eigensolver_gpu_tpu"
_JAX_MODULES = sorted(str(p.relative_to(_JAX_PKG)) for p in _JAX_PKG.rglob("*.py"))


def _public_functions(path):
    """{name: argument names} of the module's public top-level functions."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            a = node.args
            names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            out[node.name] = names + [x.arg for x in (a.vararg, a.kwarg) if x]
    return out


def _twin(rel):
    """The port's module for a JAX module (same path; Pallas modules mapped)."""
    p = pathlib.PurePosixPath(rel)
    return ROOT / "eigensolver_gpu_torch" / p.parent / (_PALLAS_TWIN.get(p.stem, p.stem) + ".py")


def test_parity_guard_covers_the_jax_package():
    assert len(_JAX_MODULES) > 30
    for rel in ("utils/roofline.py", "ops/sygst.py", "ops/refine_planar.py"):
        assert rel in _JAX_MODULES


@pytest.mark.parametrize("rel", _JAX_MODULES)
def test_port_has_every_public_function_of_the_jax_module(rel):
    """By AST, importing neither package: each public top-level function of
    the JAX module, and each of its argument names, has a twin in the port's
    module, apart from the names the kernel loader replaces by design
    (_BY_DESIGN, each with its reason); and every allow-listed name is one
    that JAX has and the port lacks."""
    twin = _twin(rel)
    assert twin.exists(), f"{rel} has no twin {twin.relative_to(ROOT)}"
    jax_fns, port_fns = _public_functions(_JAX_PKG / rel), _public_functions(twin)
    missing = []
    for name, args in jax_fns.items():
        if name not in port_fns:
            missing.append((rel, name))
        else:
            missing += [(rel, name, arg) for arg in args if arg not in port_fns[name]]
    allowed = {key for key in _BY_DESIGN if key[0] == rel}
    assert [m for m in missing if m not in allowed] == []
    assert allowed <= set(missing), f"stale allow-list entries {sorted(allowed - set(missing))}"
