"""The planar two-stage slice of the port as a whole
(eigensolver_gpu_torch ``zhegvdx_planar`` with ``tridiag_mode='two'``:
psbrd -> planar bulge chase -> phase normalisation -> stedc -> Q2/Q1
replay), on the CPU, against the JAX package with the same configuration,
against LAPACK, and against the port's own one-stage path; and which
reduction each configuration takes.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg
import torch

import eigensolver_gpu_tpu as jax_eig
import eigensolver_gpu_torch as eig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_host as jax_zhegvdx
from eigensolver_gpu_torch.utils import tracing
from eigensolver_gpu_torch.utils.testing import compare_vectors, ge_residual, random_hpd_pair

t_model = importlib.import_module("eigensolver_gpu_torch.models.zhegvdx_planar")
t_sbrd_planar = importlib.import_module("eigensolver_gpu_torch.ops.sbrd_planar")
t_sb2st_planar = importlib.import_module("eigensolver_gpu_torch.ops.sb2st_planar")

torch.set_num_threads(2)

_MIXED = dict(compute_dtype="float32")
# name -> (n, il, iu, config fields, reduction that must run)
_CASES = {
    "n96_band8_fp64": (96, 1, 24, dict(band=8), "psbrd"),
    "n128_band16_fp64": (128, 5, 40, dict(band=16), "psbrd"),
    "n96_band8_mp": (96, 1, 24, dict(band=8, **_MIXED), "psbrd"),
    "n128_band16_mp": (128, 5, 40, dict(band=16, **_MIXED), "psbrd"),
    # n = 100 pads to 128 = 16 * 8: decoupled padding under the two-stage path
    "n100_band8_fp64_padded": (100, 5, 40, dict(band=8), "psbrd"),
    # 128 is no multiple of 24: the one-stage branch, in both packages
    "n100_band24_fp64_fallback": (100, 1, 16, dict(band=24), "hetrd_planar"),
    "n96_band8_fp64_plain_route": (96, 1, 24, dict(band=8, mosaic_kernels=False), "psbrd"),
}


def _reductions(monkeypatch):
    calls = []
    for module, name in ((t_sbrd_planar, "psbrd"), (t_model, "hetrd_planar")):
        real = getattr(module, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name", sorted(_CASES))
def test_planar_two_stage_solve_matches_jax(monkeypatch, name):
    """Eigenvalues within 1e-10 of the JAX package's with the same
    configuration (and of LAPACK's), eigenvectors up to a phase per column
    (1e-8: both are fp64-accurate bases of the same eigenspaces),
    ge_residual < 1e-12, B-orthonormal."""
    n, il, iu, kw, want = _CASES[name]
    a, b = random_hpd_pair(n, seed=len(name) + n)
    calls = _reductions(monkeypatch)
    res = eig.zhegvdx_planar_host(a, b, il=il, iu=iu, device="cpu",
                                  cfg=eig.SolverConfig(tridiag_mode="two", **kw))
    # the mixed mode runs the fp32 pipeline once, inside the outer call
    assert calls == [want]
    jw, jzr, jzi, jinfo = jax_zhegvdx(a, b, il=il, iu=iu,
                                      cfg=jax_eig.SolverConfig(tridiag_mode="two", **kw))
    m = iu - il + 1
    w, z = res.w.numpy(), res.zr.numpy() + 1j * res.zi.numpy()
    assert int(res.info) == int(jinfo) == 0
    assert w.shape == (m,) and z.shape == (n, m) and res.w.dtype == torch.float64
    assert np.abs(w - np.asarray(jw)).max() < 1e-10
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_ref[il - 1 : iu]).max() < 1e-10
    assert compare_vectors(z, np.asarray(jzr) + 1j * np.asarray(jzi)) < 1e-8
    assert ge_residual(a, b, w, z) < 1e-12
    assert np.abs(z.conj().T @ b @ z - np.eye(m)).max() < 1e-11


@pytest.mark.parametrize("kw,n,want", [
    (dict(tridiag_mode="two", band=8), 32, "psbrd"),  # npad = 32 >= 3 * 8
    (dict(tridiag_mode="two"), 64, "hetrd_planar"),  # npad = 64 < 3 * 32 falls back
    (dict(tridiag_mode="two"), 90, "psbrd"),  # npad = 96 = 3 * band
    (dict(tridiag_mode="auto", planar_two_stage_min_n=32), 96, "hetrd_planar"),
    (dict(tridiag_mode="auto", planar_two_stage_min_n=32, **_MIXED), 96, "hetrd_planar"),
    (dict(tridiag_mode="one", band=8), 96, "hetrd_planar"),
    (dict(tridiag_mode="two", **_MIXED), 96, "psbrd"),
])
def test_which_planar_reduction_runs(monkeypatch, kw, n, want):
    """'two' engages the two-stage reduction when the padded size allows it;
    'auto' stays one-stage whatever planar_two_stage_min_n says."""
    calls = _reductions(monkeypatch)
    a, b = random_hpd_pair(n, seed=41)
    res = eig.zhegvdx_planar_host(a, b, il=1, iu=8, cfg=eig.SolverConfig(**kw), device="cpu")
    assert int(res.info) == 0 and calls == [want]
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(res.w.numpy() - w_ref[:8]).max() < 1e-10


@pytest.mark.parametrize("n,il,iu,kw", [
    (100, 1, 24, {}),  # n = 100 pads to 128: decoupled padding, default band 32
    (100, 60, 100, dict(band=16)),  # the top of the spectrum, next to the padding
    (96, 1, 96, dict(band=8)),  # the whole spectrum
    (128, 5, 40, dict(replay_g=8)),
    (128, 5, 40, dict(replay_g=50)),  # g > b, no multiple of anything
    (128, 5, 40, dict(stedc_backend="xla")),
    (128, 5, 40, dict(planar_solve_mode="subst", **_MIXED)),
    (128, 5, 40, dict(mosaic_kernels=False, band=16, **_MIXED)),
])
def test_planar_two_stage_reaches_fp64_accuracy(n, il, iu, kw):
    a, b = random_hpd_pair(n, seed=42)
    cfg = eig.SolverConfig(tridiag_mode="two", **kw)
    res = eig.zhegvdx_planar_host(a, b, il=il, iu=iu, cfg=cfg, device="cpu")
    w, z = res.w.numpy(), res.zr.numpy() + 1j * res.zi.numpy()
    m = iu - il + 1
    assert int(res.info) == 0 and w.dtype == np.float64 and z.shape == (n, m)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_ref[il - 1 : iu]).max() < 1e-11 * np.abs(w_ref).max()
    assert ge_residual(a, b, w, z) < 1e-12
    assert np.abs(z.conj().T @ b @ z - np.eye(m)).max() < 1e-11


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_planar_two_stage_and_one_stage_give_the_same_eigenpairs(dtype):
    n = 128
    a, b = random_hpd_pair(n, seed=43, dtype=dtype)
    one = eig.zhegvdx_planar_host(a, b, il=3, iu=20, device="cpu",
                                  cfg=eig.SolverConfig(tridiag_mode="one"))
    two = eig.zhegvdx_planar_host(a, b, il=3, iu=20, device="cpu",
                                  cfg=eig.SolverConfig(tridiag_mode="two"))
    lo = dtype == np.complex64
    assert two.w.dtype == (torch.float32 if lo else torch.float64) and two.zr.shape == (n, 18)
    assert float((one.w - two.w).abs().max()) < (1e-4 if lo else 1e-11) * float(one.w.abs().max())
    z1 = one.zr.numpy() + 1j * one.zi.numpy()
    z2 = two.zr.numpy() + 1j * two.zi.numpy()
    assert compare_vectors(z2, z1) < (5e-2 if lo else 1e-8)


@pytest.mark.parametrize("kw", [
    dict(replay_g=100),  # 32 + 100 - 1 = 131 rows
    dict(band=64, **_MIXED),  # fp32 default g = 3 * 64: 255 rows
    dict(band=64, compute_dtype="float32", replay_g=66),  # 129 rows
], ids=["replay_g_100", "band_64_mp_default_g", "one_row_too_many"])
def test_a_planar_replay_window_past_128_rows_raises_under_mosaic_kernels(monkeypatch, kw):
    """band + g - 1 > 128 is outside kernel K10's window store. With
    mosaic_kernels on the wrapper refuses the shape (before it looks at the
    device, so on the card too) and nothing reroutes to the plain replay;
    with mosaic_kernels off the plain replay takes the same shape."""
    calls = []
    real = t_sb2st_planar.apply_q2_planar

    def counted(*args, **kwargs):
        calls.append(kwargs["g"])
        return real(*args, **kwargs)

    monkeypatch.setattr(t_sb2st_planar, "apply_q2_planar", counted)
    n = 256
    a, b = random_hpd_pair(n, seed=44)
    with pytest.raises(ValueError, match="exceeds the window size 128"):
        eig.zhegvdx_planar_host(a, b, il=1, iu=4, device="cpu",
                                cfg=eig.SolverConfig(tridiag_mode="two", **kw))
    assert calls == []
    res = eig.zhegvdx_planar_host(
        a, b, il=1, iu=4, device="cpu",
        cfg=eig.SolverConfig(tridiag_mode="two", mosaic_kernels=False, **kw))
    band = kw.get("band", 32)
    assert calls == [kw.get("replay_g", 3 * band)]
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(res.w.numpy() - w_ref[:4]).max() < 1e-10


@pytest.mark.parametrize("kw", [
    dict(replay_g=97),  # 32 + 97 - 1 = 128 rows: the largest window
    dict(band=64, replay_g=65),
])
def test_the_largest_planar_replay_window_solves_under_mosaic_kernels(kw):
    n = 256
    a, b = random_hpd_pair(n, seed=47)
    res = eig.zhegvdx_planar_host(a, b, il=1, iu=4, device="cpu",
                                  cfg=eig.SolverConfig(tridiag_mode="two", **kw))
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert int(res.info) == 0 and np.abs(res.w.numpy() - w_ref[:4]).max() < 1e-10


def test_planar_two_stage_stages_are_traced():
    """The ranges chip_smoke.py reads its stage times from, in order."""
    a, b = random_hpd_pair(128, seed=45)
    tracing.clear()
    tracing.enable(sync=True)
    try:
        eig.zhegvdx_planar_host(a, b, il=1, iu=8, device="cpu",
                                cfg=eig.SolverConfig(tridiag_mode="two"))
    finally:
        tracing.disable()
    names = [name for name, _ in tracing.timings()]
    tracing.clear()
    order = ("psbrd", "bulge_chase_planar", "stedc", "apply_q2_planar", "apply_q1_planar")
    for want in order + ("zhegvdx_planar",):
        assert names.count(want) == 1, (want, names)
    assert [names.index(x) for x in order] == sorted(names.index(x) for x in order)
    assert "hetrd_planar" not in names and "unmtr_planar" not in names


def test_trinv_still_raises_with_the_two_stage_path():
    a, b = random_hpd_pair(32, seed=46)
    with pytest.raises(NotImplementedError):
        eig.zhegvdx_planar_host(a, b, il=1, iu=4, device="cpu", cfg=eig.SolverConfig(
            tridiag_mode="two", band=8, planar_solve_mode="trinv"))
