"""The port's full planar triangular inverse (ops/planar.ptrinv_lower) and
the ``planar_solve_mode='trinv'`` route of ``zhegvdx_planar`` against the
JAX package, on the CPU.

``ptrinv_lower`` is held against JAX's in fp64 (1e-12 relative to the
inverse's largest entry) and fp32 (1e-4: the same products summed in
another order); the solves against JAX's with the same configuration, as
JAX's own tests/test_planar_pipeline.py holds its 'trinv' route: the mixed
solve to the fp64 contract, the pure fp32 solve to eps32 * kappa.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg
import torch

import eigensolver_gpu_tpu as jax_eig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_host as jax_zhegvdx
from eigensolver_gpu_tpu.ops.planar import ptrinv_lower as jax_ptrinv
from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar_batched, zhegvdx_planar_host
from eigensolver_gpu_torch.ops.planar import pcholesky_lower, ptrinv_lower
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    ge_residual,
    orthonormality_error,
    random_hpd_pair,
)

t_model = importlib.import_module("eigensolver_gpu_torch.models.zhegvdx_planar")

torch.set_num_threads(2)

T = lambda x, dt=torch.float64: torch.tensor(np.ascontiguousarray(x), dtype=dt)


def _factor(n, seed, dtype):
    """The planar Cholesky factor of random_hpd_pair's B (well conditioned)."""
    _, b = random_hpd_pair(n, seed=seed)
    l = np.linalg.cholesky(b)
    return l.real.astype(dtype), l.imag.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("base", [32, 64, 128])
@pytest.mark.parametrize("n", [128, 256])
def test_ptrinv_lower_matches_jax(n, base, dtype):
    """inv(L) at n = 128 and 256 by blocks of 32, 64 and 128 (up to three
    doubling levels): within 1e-12 (fp64) / 1e-4 (fp32) relative of JAX's,
    lower triangular, and L inv(L) = I to the dtype's accuracy."""
    lr, li = _factor(n, 7 + n + base, dtype)
    dt = torch.float64 if dtype == np.float64 else torch.float32
    ir, ii = ptrinv_lower((T(lr, dt), T(li, dt)), base=base)
    jr, ji = jax_ptrinv((lr, li), base=base)
    got = ir.double().numpy() + 1j * ii.double().numpy()
    want = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
    tol = 1e-12 if dtype == np.float64 else 1e-4
    assert ir.dtype == dt and ir.shape == (n, n)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert np.abs(np.triu(got, 1)).max() == 0.0
    l = lr.astype(np.float64) + 1j * li.astype(np.float64)
    assert np.abs(l @ got - np.eye(n)).max() < (1e-13 if dtype == np.float64 else 1e-5) * n


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ptrinv_lower_batched_matches_items(dtype):
    """A batch of 3 factors (leading axis): each item equal to its own call
    (1e-14 fp64 / 1e-6 fp32 relative: the batched products may block the
    sums differently)."""
    n, base = 256, 64
    facs = [_factor(n, 30 + k, np.float64) for k in range(3)]
    lr = T(np.stack([f[0] for f in facs]), dtype)
    li = T(np.stack([f[1] for f in facs]), dtype)
    ir, ii = ptrinv_lower((lr, li), base=base)
    assert ir.shape == (3, n, n)
    tol = 1e-14 if dtype == torch.float64 else 1e-6
    for k in range(3):
        one = ptrinv_lower((lr[k], li[k]), base=base)
        scale = float(one[0].abs().max())
        assert float((ir[k] - one[0]).abs().max()) <= tol * scale
        assert float((ii[k] - one[1]).abs().max()) <= tol * scale


@pytest.mark.parametrize("n,base", [(96, 32), (100, 32), (384, 128), (64, 128)])
def test_ptrinv_lower_refuses_sizes_that_are_not_base_times_a_power_of_two(n, base):
    """n must be base * 2^k, as in JAX (96 = 3 * 32, 100 % 32 != 0, 384 = 3 * 128,
    64 < 128)."""
    z = torch.zeros(n, n, dtype=torch.float64)
    with pytest.raises(ValueError):
        ptrinv_lower((z, z), base=base)
    with pytest.raises(ValueError):
        jax_ptrinv((z.numpy(), z.numpy()), base=base)


def _solves(monkeypatch):
    calls = []
    for name in ("ptrinv_lower", "ptrsm_left_lower_inv", "ptrsm_left_lower"):
        real = getattr(t_model, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(t_model, name, counted)
    return calls


@pytest.mark.parametrize("mode,dtype,n,want", [
    ("trinv", np.complex64, 128, ["ptrinv_lower"]),
    ("trinv", np.complex64, 256, ["ptrinv_lower"]),
    ("trinv", np.complex64, 64, ["ptrsm_left_lower_inv"] * 3),  # 64 % 128 != 0
    ("trinv", np.complex128, 128, ["ptrsm_left_lower"] * 3),  # the gate wants fp32
    ("blockinv", np.complex64, 128, ["ptrsm_left_lower_inv"] * 3),
    ("subst", np.complex64, 128, ["ptrsm_left_lower"] * 3),
    ("blockinv", np.complex128, 128, ["ptrsm_left_lower"] * 3),
])
def test_solve_mode_gate(monkeypatch, mode, dtype, n, want):
    """Which triangular solves run, by JAX's gate (models/zhegvdx_planar.py:
    fp32 with n / 128 a power of two for 'trinv'; else the block-inverted
    substitution in fp32 but under 'subst', and exact substitution in fp64);
    every route solves (ge_residual at the dtype's level)."""
    a, b = random_hpd_pair(n, seed=11)
    calls = _solves(monkeypatch)
    res = zhegvdx_planar_host(a.astype(dtype), b.astype(dtype), il=1, iu=8, device="cpu",
                              cfg=SolverConfig(planar_solve_mode=mode))
    assert calls == want
    z = res.zr.double().numpy() + 1j * res.zi.double().numpy()
    tol = 1e-4 if dtype == np.complex64 else 1e-12
    assert int(res.info) == 0 and ge_residual(a, b, res.w.double().numpy(), z) < tol


def test_mixed_trinv_matches_jax():
    """Mixed precision at n = 128 (one doubling level of inv(L)), iu = 32,
    as JAX's test_zhegvdx_planar_mixed_trinv: eigenvalues within 1e-11 of
    JAX's and 1e-9 n of LAPACK's, vectors phase-insensitively within 1e-8,
    ge_residual < 1e-12, B-orthonormal to 1e-9 n."""
    n = 128
    a, b = random_hpd_pair(n, seed=97)
    kw = dict(compute_dtype="float32", refine_iters=2, planar_solve_mode="trinv")
    res = zhegvdx_planar_host(a, b, il=1, iu=32, cfg=SolverConfig(**kw), device="cpu")
    jw, jzr, jzi, jinfo = jax_zhegvdx(a, b, il=1, iu=32, cfg=jax_eig.SolverConfig(**kw))
    w, z = res.w.numpy(), res.zr.numpy() + 1j * res.zi.numpy()
    assert int(res.info) == int(jinfo) == 0
    assert np.abs(w - np.asarray(jw)).max() < 1e-11
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.allclose(w, w_ref[:32], atol=1e-9 * n)
    assert compare_vectors(z, np.asarray(jzr) + 1j * np.asarray(jzi)) < 1e-8
    assert ge_residual(a, b, w, z) < 1e-12
    assert orthonormality_error(z, b) < 1e-9 * n


def test_pure_fp32_trinv_matches_jax():
    """The pure fp32 solve (no refinement), all 128 eigenpairs, as JAX's
    test_zhegvdx_planar_trinv_pure_fp32: eigenvalues within 5e-3 n of
    LAPACK's and within 1e-3 of JAX's (fp32 products in another order),
    ge_residual < 1e-4."""
    n = 128
    a, b = random_hpd_pair(n, seed=98)
    a32, b32 = a.astype(np.complex64), b.astype(np.complex64)
    res = zhegvdx_planar_host(a32, b32, il=1, iu=n, device="cpu",
                              cfg=SolverConfig(planar_solve_mode="trinv"))
    jw, _, _, jinfo = jax_zhegvdx(a32, b32, il=1, iu=n,
                                  cfg=jax_eig.SolverConfig(planar_solve_mode="trinv"))
    w = res.w.double().numpy()
    z = res.zr.double().numpy() + 1j * res.zi.double().numpy()
    assert res.w.dtype == torch.float32 and int(res.info) == int(jinfo) == 0
    assert np.abs(w - np.asarray(jw, np.float64)).max() < 1e-3
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.allclose(w, w_ref, atol=5e-3 * n)
    assert ge_residual(a, b, w, z) < 1e-4


def test_trinv_with_the_two_stage_reduction_matches_jax():
    """'trinv' with tridiag_mode='two' (band 16), mixed at n = 128, il = 5
    .. iu = 40: against JAX's solve with the same configuration, as the
    two-stage tests hold 'blockinv' (eigenvalues 1e-10, vectors 1e-8,
    ge_residual < 1e-12)."""
    n, il, iu = 128, 5, 40
    a, b = random_hpd_pair(n, seed=99)
    kw = dict(compute_dtype="float32", tridiag_mode="two", band=16, planar_solve_mode="trinv")
    res = zhegvdx_planar_host(a, b, il=il, iu=iu, cfg=SolverConfig(**kw), device="cpu")
    jw, jzr, jzi, jinfo = jax_zhegvdx(a, b, il=il, iu=iu, cfg=jax_eig.SolverConfig(**kw))
    w, z = res.w.numpy(), res.zr.numpy() + 1j * res.zi.numpy()
    assert int(res.info) == int(jinfo) == 0
    assert np.abs(w - np.asarray(jw)).max() < 1e-10
    assert compare_vectors(z, np.asarray(jzr) + 1j * np.asarray(jzi)) < 1e-8
    assert ge_residual(a, b, w, z) < 1e-12


@pytest.mark.parametrize("chunk", [None, 2])
def test_batched_trinv_matches_unbatched_solves(chunk):
    """zhegvdx_planar_batched with 'trinv', mixed, a batch of 4 at n = 128:
    one inv(L) a block step for the batch; each item's eigenvalues within
    1e-12 relative and vectors within 1e-8 of its unbatched solve."""
    n, iu, batch = 128, 16, 4
    pairs = [random_hpd_pair(n, seed=40 + k) for k in range(batch)]
    stack = lambda f: T(np.stack([f(p) for p in pairs]))
    cfg = SolverConfig(compute_dtype="float32", planar_solve_mode="trinv")
    res = zhegvdx_planar_batched(stack(lambda p: p[0].real), stack(lambda p: p[0].imag),
                                 stack(lambda p: p[1].real), stack(lambda p: p[1].imag),
                                 il=1, iu=iu, cfg=cfg, chunk=chunk)
    assert res.w.shape == (batch, iu) and res.info.tolist() == [0] * batch
    for k, (a, b) in enumerate(pairs):
        one = zhegvdx_planar_host(a, b, il=1, iu=iu, cfg=cfg, device="cpu")
        w = res.w[k].numpy()
        z = res.zr[k].numpy() + 1j * res.zi[k].numpy()
        assert np.abs(w - one.w.numpy()).max() < 1e-12 * np.abs(w).max()
        assert compare_vectors(z, one.zr.numpy() + 1j * one.zi.numpy()) < 1e-8
        assert ge_residual(a, b, w, z) < 1e-12


def test_trinv_factor_solves_match_the_substitution():
    """On the same fp32 factor, inv(L) @ B and the block-inverted
    substitution agree to eps32 * kappa (1e-4 relative)."""
    n = 256
    _, b = random_hpd_pair(n, seed=12)
    l, info = pcholesky_lower((T(b.real, torch.float32), T(b.imag, torch.float32)), nb=128)
    rng = np.random.default_rng(13)
    rhs = (T(rng.standard_normal((n, 8)), torch.float32),
           T(rng.standard_normal((n, 8)), torch.float32))
    from eigensolver_gpu_torch.ops.planar import pmatmul, ptrsm_left_lower_inv

    got = pmatmul(ptrinv_lower(l), rhs)
    want = ptrsm_left_lower_inv(l, rhs, nb=128)
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    assert int(info) == 0
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-4 * scale
