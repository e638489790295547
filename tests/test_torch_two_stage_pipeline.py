"""The real two-stage slice of the port as a whole
(eigensolver_gpu_torch ``dsygvdx`` / ``sygvdx`` / ``syevdx`` with the
sbrd -> bulge chase -> Q2/Q1 replay reduction), on the CPU: which
reduction each configuration takes, held to the JAX package's rule, and
what the two-stage path returns, held to LAPACK and to the one-stage path.
The comparisons of whole solves with the JAX package are cases of
tests/test_torch_real_pipeline.py and tests/test_torch_real_mixed.py.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg
import torch

import eigensolver_gpu_tpu as jax_eig
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.utils import tracing
from eigensolver_gpu_torch.utils.convert import dense_from_numpy
from eigensolver_gpu_torch.utils.testing import compare_vectors, ge_residual
from test_torch_real_helpers import make_pair

j_syevdx = importlib.import_module("eigensolver_gpu_tpu.models.syevdx")
t_syevdx = importlib.import_module("eigensolver_gpu_torch.models.syevdx")
t_sbrd = importlib.import_module("eigensolver_gpu_torch.ops.sbrd")

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["one", "two", "auto"])
@pytest.mark.parametrize("iscomplex", [False, True])
@pytest.mark.parametrize("compute_is_f64", [False, True])
@pytest.mark.parametrize("n,min_n", [(64, 4096), (4096, 4096), (8192, 4096), (128, 96)])
def test_use_two_stage_is_the_jax_rule(n, min_n, compute_is_f64, iscomplex, mode):
    """Same decision as the JAX package off a TPU: 'two' for real input,
    'auto' for fp64 compute at n >= two_stage_min_n, never for complex
    input, never for fp32 compute under 'auto'."""
    kw = dict(tridiag_mode=mode, two_stage_min_n=min_n)
    got = t_syevdx._use_two_stage(n, eig.SolverConfig(**kw), iscomplex, compute_is_f64)
    want = j_syevdx._use_two_stage(n, jax_eig.SolverConfig(**kw), iscomplex, compute_is_f64)
    assert got == want
    if mode == "auto" and not iscomplex:
        assert got == (compute_is_f64 and n >= min_n)


def _reductions(monkeypatch):
    calls = []
    for name in ("sbrd", "sytrd"):
        real = getattr(t_syevdx if name == "sytrd" else t_sbrd, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(t_syevdx if name == "sytrd" else t_sbrd, name, counted)
    return calls


@pytest.mark.parametrize("dtype,kw,n,want", [
    (np.float64, dict(tridiag_mode="two"), 128, "sbrd"),
    (np.float32, dict(tridiag_mode="two"), 128, "sbrd"),
    (np.float64, dict(tridiag_mode="two", compute_dtype="float32"), 128, "sbrd"),
    (np.float64, dict(two_stage_min_n=96), 128, "sbrd"),
    (np.float64, dict(two_stage_min_n=96, tridiag_mode="one"), 128, "sytrd"),
    (np.float64, {}, 128, "sytrd"),  # below the default two_stage_min_n
    (np.float32, dict(two_stage_min_n=96), 128, "sytrd"),  # fp32 'auto' stays one-stage
    (np.float64, dict(two_stage_min_n=96, compute_dtype="float32"), 128, "sytrd"),
    (np.complex128, dict(tridiag_mode="two"), 96, "sytrd"),  # complex: one-stage always
    (np.float64, dict(tridiag_mode="two"), 90, "sbrd"),  # npad = 96 = 3 * band
    (np.float64, dict(tridiag_mode="two"), 64, "sytrd"),  # npad < 3 * band falls back
    (np.float64, dict(tridiag_mode="two", band=16), 64, "sbrd"),
])
def test_which_reduction_runs(monkeypatch, dtype, kw, n, want):
    calls = _reductions(monkeypatch)
    a, b = make_pair(n, dtype)
    res = eig.sygvdx(*dense_from_numpy(a, b, device="cpu"), il=1, iu=8, cfg=eig.SolverConfig(**kw))
    assert int(res.info) == 0
    assert calls == [want]
    w_ref = scipy.linalg.eigh(a.astype(np.complex128), b.astype(np.complex128), eigvals_only=True)
    lo = np.dtype(dtype) == np.float32
    assert np.abs(res.w.numpy() - w_ref[:8]).max() < (1e-4 if lo else 1e-11) * np.abs(w_ref).max()


@pytest.mark.parametrize("n,il,iu,kw", [
    (200, 1, 24, {}),  # odd n: decoupled padding to a multiple of the band
    (200, 150, 200, dict(band=16)),
    (160, 1, 160, dict(band=8)),  # the whole spectrum
    (192, 5, 40, dict(replay_g=8)),
    (192, 5, 40, dict(replay_g=50)),  # g > b, no multiple of anything
    (192, 5, 40, dict(mosaic_kernels=False)),
    (192, 5, 40, dict(compute_dtype="float32")),
    (192, 5, 40, dict(compute_dtype="float32", mosaic_kernels=False, band=16)),
])
def test_two_stage_dsygvdx_reaches_fp64_accuracy(n, il, iu, kw):
    a, b = make_pair(n, np.float64, seed=75)
    cfg = eig.SolverConfig(tridiag_mode="two", **kw)
    res = eig.dsygvdx(a, b, il=il, iu=iu, cfg=cfg, device="cpu")
    w, z = res.w.numpy(), res.z.numpy()
    m = iu - il + 1
    assert int(res.info) == 0 and w.dtype == z.dtype == np.float64
    assert w.shape == (m,) and z.shape == (n, m)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_ref[il - 1 : iu]).max() < 1e-11 * np.abs(w_ref).max()
    assert ge_residual(a, b, w, z) < 1e-12
    assert np.abs(z.T @ b @ z - np.eye(m)).max() < 1e-11


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_two_stage_and_one_stage_give_the_same_eigenpairs(dtype):
    n = 160
    a, _ = make_pair(n, dtype, seed=76)
    ta = torch.from_numpy(a)
    w1, z1 = eig.syevdx(ta, il=3, iu=20, cfg=eig.SolverConfig(tridiag_mode="one"))
    w2, z2 = eig.syevdx(ta, il=3, iu=20, cfg=eig.SolverConfig(tridiag_mode="two"))
    lo = dtype == np.float32
    assert w2.dtype == ta.dtype and z2.shape == (n, 18)
    assert float((w1 - w2).abs().max()) < (1e-4 if lo else 1e-11) * float(w1.abs().max())
    assert compare_vectors(z2.numpy(), z1.numpy()) < (5e-2 if lo else 1e-8)


def test_a_replay_window_past_128_rows_raises_on_the_kernel_route_only():
    """The kernel's rule (l_win = band + replay_g - 1 <= 128) raises a
    ValueError that names it; it never silently reroutes. The plain route
    has no such rule."""
    a, _ = make_pair(128, np.float64, seed=77)
    ta = torch.from_numpy(a)
    with pytest.raises(ValueError, match="l_win"):
        eig.syevdx(ta, il=1, iu=4, cfg=eig.SolverConfig(tridiag_mode="two", replay_g=100))
    w, _ = eig.syevdx(ta, il=1, iu=4, cfg=eig.SolverConfig(
        tridiag_mode="two", replay_g=100, mosaic_kernels=False))
    assert np.abs(w.numpy() - np.linalg.eigvalsh(a)[:4]).max() < 1e-11 * np.abs(a).max() * 128


def test_two_stage_stages_are_traced():
    """The ranges chip_smoke.py reads its stage times from."""
    a, b = make_pair(128, np.float64, seed=78)
    tracing.clear()
    tracing.enable(sync=True)
    try:
        eig.dsygvdx(a, b, il=1, iu=8, cfg=eig.SolverConfig(tridiag_mode="two"), device="cpu")
    finally:
        tracing.disable()
    names = [name for name, _ in tracing.timings()]
    tracing.clear()
    for want in ("sbrd", "bulge_chase", "apply_q2", "apply_q1", "stedc", "syevdx", "sygvdx"):
        assert names.count(want) == 1, (want, names)
    assert names.index("sbrd") < names.index("bulge_chase") < names.index("stedc") \
        < names.index("apply_q2") < names.index("apply_q1")
