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
) + ["chip_smoke.py"]


def test_port_file_list_covers_the_package():
    assert len(_PORT_FILES) > 25
    for name in ("models/sygvdx.py", "models/syevdx.py", "ops/symv.py", "ops/sytrd.py",
                 "ops/refine.py", "utils/kernel_guard.py", "ops/sbrd.py", "ops/sb2st.py",
                 "ops/ql_panel.py", "ops/chase.py", "ops/replay.py", "ops/sbrd_planar.py",
                 "ops/sb2st_planar.py", "models/zhegvdx_planar.py"):
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
