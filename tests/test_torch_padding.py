"""Padded solves whose standard-form matrix has a small norm, against
``scipy.linalg.eigh`` on the CPU (no JAX in this file).

A size that is not a multiple of the reduction's block is padded with a
decoupled diagonal above the spectrum (models/syevdx._pad_decoupled; the
planar driver raises its padded block after the reduction,
models/zhegvdx_planar._lift_pad). Its values are a multiple of the
standard-form matrix's max row sum (the tridiagonal matrix's Gershgorin
bound on the planar route); with JAX's ``+ 1.0`` added to that bound, a matrix of norm 1e-6 had pad values near 2 setting stedc's scale,
and the fp32 deflation threshold swallowed its spectrum: wrong eigenpairs
with info = 0. The bars are PERF.md's: eigenvalues within 1e-10 of the
largest selected |lambda|, ``ge_residual`` below 1e-12.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_torch import (
    SolverConfig,
    sygvdx,
    sygvdx_batched,
    zhegvdx_planar,
    zhegvdx_planar_batched,
)
from eigensolver_gpu_torch.utils.testing import ge_residual, random_hpd_pair, random_spd_pair

torch.set_num_threads(2)

W_TOL = 1e-10
RES_TOL = 1e-12
CFG = {
    ("mp", "one"): SolverConfig(compute_dtype="float32", tridiag_mode="one"),
    ("mp", "two"): SolverConfig(compute_dtype="float32", tridiag_mode="two"),
    ("f64", "one"): SolverConfig(tridiag_mode="one"),
    ("f64", "two"): SolverConfig(tridiag_mode="two"),
}
# route: (n, il, iu); real and complex pad n = 130 to 160, planar n = 100 to 128
SIZES = {"real": (130, 120, 130), "complex": (130, 120, 130), "planar": (100, 90, 100)}


def _pair(route, n, seed):
    if route == "real":
        return random_spd_pair(n, seed=seed)
    return random_hpd_pair(n, seed=seed)


def _solve(route, a, b, il, iu, cfg):
    """(w, z, info) as numpy, one problem or a leading batch axis."""
    t = lambda x: torch.tensor(np.ascontiguousarray(x))
    batched = a.ndim == 3
    if route == "planar":
        fn = zhegvdx_planar_batched if batched else zhegvdx_planar
        w, zr, zi, info = fn(t(a.real), t(a.imag), t(b.real), t(b.imag), il=il, iu=iu, cfg=cfg)
        return w.numpy(), zr.numpy() + 1j * zi.numpy(), info.numpy()
    w, z, info = (sygvdx_batched if batched else sygvdx)(t(a), t(b), il=il, iu=iu, cfg=cfg)
    return w.numpy(), z.numpy(), info.numpy()


def _errors(a, b, w, z, il, iu):
    """(eigenvalue error relative to the largest selected |lambda|,
    ge_residual) against scipy."""
    ref = scipy.linalg.eigh(a, b, eigvals_only=True)[il - 1 : iu]
    return float(np.abs(w - ref).max() / np.abs(ref).max()), ge_residual(a, b, w, z)


@pytest.mark.parametrize("scale", [1e-4, 1e-6, 1e-8])
@pytest.mark.parametrize("mode", ["one", "two"])
@pytest.mark.parametrize("prec", ["mp", "f64"])
@pytest.mark.parametrize("route", ["real", "complex", "planar"])
def test_padded_small_norm(route, prec, mode, scale):
    """A x scale with the top eigenpairs selected (where the pad sorts
    right after them): within the bars, info = 0. (The complex sygvdx
    route stays one-stage with ``tridiag_mode='two'``, as in JAX.)"""
    n, il, iu = SIZES[route]
    a, b = _pair(route, n, seed=0)
    a = a * scale
    w, z, info = _solve(route, a, b, il, iu, CFG[prec, mode])
    assert int(info) == 0
    assert w.shape == (iu - il + 1,) and z.shape == (n, iu - il + 1)
    werr, res = _errors(a, b, w, z, il, iu)
    assert werr < W_TOL, werr
    assert res < RES_TOL, res


@pytest.mark.parametrize("route", ["real", "complex", "planar"])
def test_padded_batch_mixed_scales(route):
    """A batch whose items are scaled 1e-6, 1 and 1e6 (one pad bound an
    item): each item meets the bars and matches its own unbatched solve."""
    n, il, iu = SIZES[route]
    cfg = CFG["mp", "one"]
    pairs = [_pair(route, n, seed=k) for k in range(3)]
    a = np.stack([p[0] * s for p, s in zip(pairs, (1e-6, 1.0, 1e6))])
    b = np.stack([p[1] for p in pairs])
    w, z, info = _solve(route, a, b, il, iu, cfg)
    assert info.tolist() == [0, 0, 0]
    for k in range(3):
        werr, res = _errors(a[k], b[k], w[k], z[k], il, iu)
        assert werr < W_TOL and res < RES_TOL, (k, werr, res)
        w1, z1, _ = _solve(route, a[k], b[k], il, iu, cfg)
        assert np.abs(w[k] - w1).max() <= 1e-12 * np.abs(w1).max()
        assert np.abs(np.abs(z[k]) - np.abs(z1)).max() <= 1e-9 * np.abs(z1).max()


@pytest.mark.parametrize("prec", ["mp", "f64"])
@pytest.mark.parametrize("route", ["real", "complex", "planar"])
def test_padded_zero_matrix(route, prec):
    """A = 0 (the bound falls back to 1): every eigenvalue 0, finite
    vectors that are B-orthonormal, info = 0."""
    n, il, iu = SIZES[route]
    _, b = _pair(route, n, seed=1)
    a = np.zeros_like(b)
    w, z, info = _solve(route, a, b, il, iu, CFG[prec, "one"])
    assert int(info) == 0
    assert np.all(w == 0.0)
    assert np.all(np.isfinite(z))
    gram = z.conj().T @ b @ z
    assert np.abs(gram - np.eye(iu - il + 1)).max() < 1e-10
