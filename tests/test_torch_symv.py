"""The port's upper-tile matvecs (eigensolver_gpu_torch/ops/symv.py: K4
``symv`` and K3 ``hemv_planar``) against the Pallas kernels they replace.

On the CPU the wrappers take their plain PyTorch versions (the same tile
walk as the CUDA kernels, both contributions per off-diagonal tile); the
JAX side runs the Pallas kernels in interpret mode through ``symv_auto``
/ ``hemv_auto``, as tests/test_symv_pallas.py does. The same numpy
inputs, made from a seed, go to both. The CUDA kernels themselves are
held to the plain versions on the card in tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigensolver_gpu_tpu.ops.hemv_pallas import hemv_auto
from eigensolver_gpu_tpu.ops.symv_pallas import symv_auto
from eigensolver_gpu_torch.ops.symv import (
    hemv_planar,
    hemv_planar_plain,
    symv,
    symv_plain,
)

torch.set_num_threads(2)


def _sym(n, dtype, seed=60):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)).astype(dtype)
    return (t + t.T) / 2, rng.standard_normal(n).astype(dtype)


def _herm(n, seed=61):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (t + t.conj().T) / 2, rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("n,tile", [(256, 128), (512, 256)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_symv_plain_matches_pallas_and_dense(n, tile, dtype):
    """fp32 1e-5 (sums of length n in another order), fp64 1e-12."""
    a, v = _sym(n, dtype)
    want = np.asarray(symv_auto(a, v, tile=tile))
    got = symv_plain(torch.from_numpy(a), torch.from_numpy(v)).numpy()
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * n)
    np.testing.assert_allclose(got, a @ v, rtol=tol, atol=tol * n)


@pytest.mark.parametrize("n", [1, 63, 100, 257])
def test_symv_takes_any_n(n):
    """No n % (2 * tile) rule: edge tiles are ragged."""
    a, v = _sym(n, np.float64, seed=n)
    got = symv(torch.from_numpy(a), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, a @ v, rtol=1e-12, atol=1e-12 * n)


def test_symv_reads_only_the_upper_tiles():
    """Garbage in the tiles strictly below the diagonal changes nothing."""
    n, tile = 200, 64
    a, v = _sym(n, np.float64)
    trashed = a.copy()
    for r0 in range(tile, n, tile):
        trashed[r0 : r0 + tile, :r0] = 1e9
    got = symv_plain(torch.from_numpy(trashed), torch.from_numpy(v), tile=tile).numpy()
    np.testing.assert_allclose(got, a @ v, rtol=1e-12, atol=1e-12 * n)


def test_symv_on_a_strided_view_and_an_extent():
    """The tridiagonalization passes a[:mb, :mb] of the padded matrix (row
    stride > mb) and restricts the product to the leading block."""
    n, mb, c = 160, 128, 77
    a, v = _sym(n, np.float64)
    ta, tv = torch.from_numpy(a), torch.from_numpy(v)
    view = ta[:mb, :mb]
    assert view.stride(0) == n and not view.is_contiguous()
    np.testing.assert_allclose(symv(view, tv[:mb]).numpy(), a[:mb, :mb] @ v[:mb],
                               rtol=1e-12, atol=1e-12 * n)
    y = symv(view, tv[:mb], extent=c)
    assert y.shape == (c,)
    np.testing.assert_allclose(y.numpy(), a[:c, :c] @ v[:c], rtol=1e-12, atol=1e-12 * n)


@pytest.mark.parametrize("n,tile", [(256, 128)])
def test_hemv_planar_plain_matches_pallas_and_dense(n, tile):
    a, v = _herm(n)
    want = np.asarray(hemv_auto(jnp.asarray(a), jnp.asarray(v), tile=tile))
    T = lambda x: torch.tensor(np.ascontiguousarray(x))
    yr, yi = hemv_planar_plain(T(a.real), T(a.imag), T(v.real), T(v.imag))
    got = yr.numpy() + 1j * yi.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * n)
    np.testing.assert_allclose(got, a @ v, rtol=1e-12, atol=1e-12 * n)


@pytest.mark.parametrize("n,extent", [(100, None), (130, 71)])
def test_hemv_planar_any_n_view_and_extent(n, extent):
    a, v = _herm(n + 30, seed=n)
    T = lambda x: torch.tensor(np.ascontiguousarray(x))
    ar, ai = T(a.real)[:n, :n], T(a.imag)[:n, :n]
    yr, yi = hemv_planar(ar, ai, T(v.real)[:n], T(v.imag)[:n], extent=extent)
    c = n if extent is None else extent
    want = a[:c, :c] @ v[:c]
    assert yr.shape == (c,)
    np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), want, rtol=1e-12, atol=1e-12 * n)


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    a, v = _sym(96, np.float32)
    ta, tv = torch.from_numpy(a), torch.from_numpy(v)
    before = (symv.launches, hemv_planar.launches)
    assert torch.equal(symv(ta, tv), symv_plain(ta, tv))
    z = torch.zeros_like(ta)
    yr, yi = hemv_planar(ta, z, tv, torch.zeros_like(tv))
    assert torch.equal(yr, hemv_planar_plain(ta, z, tv, torch.zeros_like(tv))[0])
    assert not yi.any()
    assert (symv.launches, hemv_planar.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros((8, 8))
    v = torch.zeros(8)
    with pytest.raises(ValueError):
        symv(torch.zeros((8, 6)), v)
    with pytest.raises(ValueError):
        symv(a, torch.zeros(7))
    with pytest.raises(ValueError):
        symv(torch.zeros((8, 16))[:, ::2], v)  # column stride 2
    with pytest.raises(ValueError):
        symv(a, v.double())
    with pytest.raises(TypeError):
        symv(a.to(torch.complex64), v.to(torch.complex64))
    with pytest.raises(ValueError):
        symv(a, v, extent=9)
    with pytest.raises(ValueError):
        hemv_planar(a, torch.zeros((8, 8), dtype=torch.float64), v, v)
