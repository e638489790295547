"""The port's real and complex-dtype drivers (eigensolver_gpu_torch:
``sygvdx`` / ``dsygvdx`` / ``zhegvdx`` / ``syevdx``) as a whole against
the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``utils.convert.dense_from_numpy`` into the port (CPU tensors, so the
kernel wrappers take their plain versions) and straight into the JAX
drivers (XLA branches; the Pallas symv in interpret mode where
``use_pallas`` reaches it; its XLA two-stage route under
``tridiag_mode='two'``). The fp64-input mixed-precision cases, whose JAX
side compiles slowly, are in tests/test_torch_real_mixed.py.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import eigensolver_gpu_tpu as jax_eig
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.utils.convert import dense_from_numpy
from eigensolver_gpu_torch.utils.testing import ge_residual
from test_torch_real_helpers import check_against_jax, make_pair

torch.set_num_threads(2)


_CASES = {
    # name: (driver, n, dtype, config, il, iu)
    "f64_odd_padding": ("dsygvdx", 96, np.float64, {}, 1, 12),
    "f64_top_range": ("sygvdx", 128, np.float64, {}, 100, 128),
    "f32": ("dsygvdx", 128, np.float32, {}, 1, 16),
    "c128_odd_padding": ("zhegvdx", 96, np.complex128, {}, 2, 17),
    "c128_mixed": ("zhegvdx", 128, np.complex128, dict(compute_dtype="float32"), 1, 16),
    "c64": ("zhegvdx", 128, np.complex64, {}, 1, 16),
    # complex input is one-stage in every tridiag_mode, in both packages
    "c128_two_stage_mode": ("zhegvdx", 96, np.complex128, dict(tridiag_mode="two"), 1, 12),
    "f64_sygst_full": ("sygvdx", 256, np.float64, dict(sygst_mode="full"), 1, 32),
    "f64_sygst_blocked": ("sygvdx", 256, np.float64, dict(sygst_mode="blocked", nb_sygst=64),
                          1, 32),
    "f32_sygst_inv": ("sygvdx", 256, np.float32, dict(sygst_mode="inv", nb_sygst=64), 1, 32),
    "f32_sygst_trinv": ("sygvdx", 512, np.float32, dict(sygst_mode="trinv"), 1, 32),
    "f32_sygst_trinv_falls_back": ("sygvdx", 256, np.float32, dict(sygst_mode="trinv"), 1, 32),
    "f64_stedc_xla": ("dsygvdx", 128, np.float64, dict(stedc_backend="xla"), 3, 20),
    "f32_use_pallas": ("dsygvdx", 512, np.float32, dict(use_pallas=True), 1, 32),
    "syevdx_f64_odd_padding": ("syevdx", 96, np.float64, {}, 2, 17),
    "syevdx_c128": ("syevdx", 96, np.complex128, {}, 1, 12),
    "syevdx_f32_top": ("syevdx", 128, np.float32, {}, 120, 128),
    "syevdx_xla": ("syevdx", 128, np.float64, dict(stedc_backend="xla"), 1, 8),
    # the two-stage reduction (sbrd -> bulge chase -> Q2/Q1 replay): the port
    # on CPU tensors takes the kernels' plain versions, JAX its XLA route
    "f64_two_stage": ("dsygvdx", 128, np.float64, dict(tridiag_mode="two"), 1, 16),
    "f64_two_stage_odd_n_band8": ("dsygvdx", 100, np.float64,
                                  dict(tridiag_mode="two", band=8), 2, 17),
    "f32_two_stage": ("dsygvdx", 128, np.float32, dict(tridiag_mode="two"), 1, 16),
    "f64_auto_goes_two_stage": ("sygvdx", 128, np.float64, dict(two_stage_min_n=96), 1, 16),
    "f64_two_stage_below_3_bands_is_one_stage": ("dsygvdx", 64, np.float64,
                                                 dict(tridiag_mode="two"), 1, 8),
    "f64_two_stage_plain_route": ("dsygvdx", 128, np.float64,
                                  dict(tridiag_mode="two", mosaic_kernels=False), 1, 16),
    "syevdx_two_stage_top": ("syevdx", 128, np.float64, dict(tridiag_mode="two"), 120, 128),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_driver_matches_jax(case):
    check_against_jax(*_CASES[case])


def test_use_pallas_routes_the_matvec_through_symv(monkeypatch):
    """n=512 fp32: syevdx tridiagonalizes with 256-row buckets, so the
    mb=512 bucket's 256 columns go through the symv wrapper, and the
    result is the use_pallas=False one to fp32 accuracy."""
    from eigensolver_gpu_torch.ops import sytrd

    calls = []
    real = sytrd.symv
    monkeypatch.setattr(sytrd, "symv", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    a, b = make_pair(512, np.float32)
    ta, tb = dense_from_numpy(a, b, device="cpu")
    on = eig.dsygvdx(ta, tb, il=1, iu=16, cfg=eig.SolverConfig(use_pallas=True))
    assert len(calls) == 256
    off = eig.dsygvdx(ta, tb, il=1, iu=16, cfg=eig.SolverConfig())
    assert len(calls) == 256
    assert np.abs(on.w.numpy() - off.w.numpy()).max() < 1e-4 * np.abs(off.w.numpy()).max()


def _non_pd(first_bad):
    a, b = make_pair(64, np.float64, seed=71)
    b = b.copy()
    b[first_bad, first_bad] = -50.0
    return a, b


@pytest.mark.parametrize("mixed", [False, True])
def test_non_pd_b_gives_info_without_an_exception(mixed):
    """info > 0, no exception. With the bad pivot in row 1 the value is
    JAX's too; in row 10 the port reports 10 (LAPACK devInfo) where the
    JAX function on the CPU backend reports 1 (XLA's CPU Cholesky turns
    the whole factor NaN)."""
    kw = dict(compute_dtype="float32") if mixed else {}
    a, b = _non_pd(0)
    res = eig.dsygvdx(a, b, il=1, iu=8, cfg=eig.SolverConfig(**kw), device="cpu")
    jres = jax_eig.dsygvdx(a, b, il=1, iu=8, cfg=jax_eig.SolverConfig(**kw))
    assert int(res.info) == int(jres.info) == 1
    assert res.w.shape == (8,) and res.z.shape == (64, 8)
    a, b = _non_pd(9)
    res = eig.dsygvdx(a, b, il=1, iu=8, cfg=eig.SolverConfig(**kw), device="cpu")
    assert int(res.info) == 10 and res.info.dtype == torch.int32


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("il,iu", [(0, 4), (5, 4), (1, 33), (-3, 2)])
def test_index_range_is_validated_on_every_branch(il, iu, mixed):
    a, b = make_pair(32, np.float64)
    cfg = eig.SolverConfig(compute_dtype="float32" if mixed else None)
    with pytest.raises(ValueError):
        eig.dsygvdx(a, b, il=il, iu=iu, cfg=cfg, device="cpu")
    with pytest.raises(ValueError):
        eig.syevdx(torch.from_numpy(a), il=il, iu=iu, cfg=cfg)


def test_shape_and_dtype_checks():
    a, b = make_pair(16, np.float64)
    za, zb = make_pair(16, np.complex128)
    with pytest.raises(ValueError):
        eig.dsygvdx(a, b[:8, :8], device="cpu")
    with pytest.raises(ValueError):
        eig.sygvdx(torch.from_numpy(a[:, :8]), torch.from_numpy(b))
    with pytest.raises(TypeError):
        eig.zhegvdx(a, b, device="cpu")
    with pytest.raises(TypeError):
        eig.dsygvdx(za, zb, device="cpu")
    with pytest.raises(TypeError):
        eig.dsygvdx(torch.from_numpy(za), torch.from_numpy(zb))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_only_the_upper_triangles_are_read(dtype):
    """UPLO='U': garbage in the strict lower triangles changes nothing."""
    n = 48
    a, b = make_pair(n, dtype)
    rng = np.random.default_rng(72)
    trash = lambda x: x + 1e3 * np.tril(rng.standard_normal((n, n)), -1)
    r0 = eig.sygvdx(*dense_from_numpy(a, b, device="cpu"), il=1, iu=8)
    r1 = eig.sygvdx(*dense_from_numpy(trash(a), trash(b), device="cpu"), il=1, iu=8)
    assert int(r1.info) == 0
    assert torch.equal(r0.w, r1.w) and torch.equal(r0.z, r1.z)


def test_unported_options_raise():
    a, b = make_pair(32, np.float64)
    from eigensolver_gpu_torch.ops.refine import refine_gevp

    ta, tb = dense_from_numpy(a, b, device="cpu")
    with pytest.raises(NotImplementedError):
        refine_gevp(ta, tb, ta, gemm="ozaki")


def test_numpy_and_tensor_inputs_agree_and_stay_on_their_device():
    """numpy arrays go to the ``device`` keyword; tensors are solved where
    they lie, whatever the keyword says; dense_from_numpy keeps dtypes."""
    a, b = make_pair(32, np.float64)
    ta, tb = dense_from_numpy(a, b, device="cpu")
    assert ta.dtype == torch.float64 and ta.is_contiguous() and np.array_equal(ta.numpy(), a)
    assert dense_from_numpy(a, b, device="cpu", dtype=torch.float32)[1].dtype == torch.float32
    r0 = eig.dsygvdx(a, b, il=1, iu=4, device="cpu")
    r1 = eig.dsygvdx(ta, tb, il=1, iu=4)  # default device="cuda" is not used
    assert r0.w.device.type == r1.z.device.type == "cpu"
    assert torch.equal(r0.w, r1.w) and torch.equal(r0.z, r1.z)
    order = np.asfortranarray(a)
    r2 = eig.dsygvdx(order, b, il=1, iu=4, device="cpu")
    assert torch.allclose(r0.w, r2.w, rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_tiny_matrices(n):
    a, b = make_pair(n, np.float64)
    res = eig.dsygvdx(a, b, device="cpu")
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert int(res.info) == 0
    assert np.abs(res.w.numpy() - w_ref).max() < 1e-12 * max(1.0, np.abs(w_ref).max())
    assert ge_residual(a, b, res.w.numpy(), res.z.numpy()) < 1e-13
