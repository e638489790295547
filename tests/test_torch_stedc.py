"""The port's divide and conquer (eigensolver_gpu_torch/ops/stedc.py) on
the adversarial spectra of tests/test_stedc.py, against
scipy.linalg.eigh_tridiagonal, at the same tolerances.

fp64 runs with the dense-eigh leaf (``leaf_solver='xla'``) until the
Jacobi leaf is ported; the cases stress the masked deflation, the pole
separation and the fixed-count secular iteration.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_torch.ops.stedc import stedc

torch.set_num_threads(2)


def _check(d, e, leaf=16, wtol=1e-12, rtol=1e-11, otol=1e-11):
    n = d.shape[0]
    w, q = stedc(torch.tensor(d), torch.tensor(e), leaf=leaf, leaf_solver="xla")
    w, q = w.numpy(), q.numpy()
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    w_ref = scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)
    scale = max(np.max(np.abs(w_ref)), 1.0)
    assert np.all(np.diff(w) >= -1e-14 * scale), "eigenvalues not sorted"
    np.testing.assert_allclose(w, w_ref, atol=wtol * scale * n, rtol=0)
    res = np.max(np.abs(t @ q - q * w[None, :])) / (scale * n)
    assert res < rtol, f"residual {res:.2e}"
    orth = np.max(np.abs(q.T @ q - np.eye(n)))
    assert orth < otol * n, f"orthogonality {orth:.2e}"


def _random(n):
    rng = np.random.default_rng(n)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _graded():
    n = 64
    d = np.logspace(0, -12, n)
    e = 1e-3 * d[:-1] * np.random.default_rng(2).standard_normal(n - 1)
    return d, e


def _decoupled():
    rng = np.random.default_rng(3)
    d, e = rng.standard_normal(48), rng.standard_normal(47)
    e[10] = e[31] = 0.0
    return d, e


def _wilkinson():
    n = 21
    return np.abs(np.arange(n) - (n - 1) // 2).astype(np.float64), np.ones(n - 1)


def _heavy_deflation():
    """Large identical blocks with tiny couplings: deflation at every
    merge; 6 leaves of 64 fold as 4 + 2."""
    n = 384
    d = np.repeat(np.linspace(1.0, 3.0, 8), n // 8)
    e = np.full(n - 1, 1e-13)
    e[:: n // 8] = 0.5
    return d, e


_CASES = {
    "random4": (lambda: _random(4), {}),
    "random33": (lambda: _random(33), {}),
    "random130": (lambda: _random(130), {}),
    "random256": (lambda: _random(256), {}),
    "identity_ties": (lambda: (np.ones(64), np.zeros(63)), {}),
    "near_ties": (lambda: (np.ones(64), 1e-14 * np.random.default_rng(1).standard_normal(63)), {}),
    "clustered_121": (lambda: (2.0 * np.ones(128), np.ones(127)), {}),
    "graded": (_graded, {"wtol": 1e-11}),
    "decoupled": (_decoupled, {}),
    "wilkinson": (_wilkinson, {"leaf": 8}),
    "negative_e": (lambda: (np.random.default_rng(4).standard_normal(64),
                            -np.abs(np.random.default_rng(4).standard_normal(63))), {}),
    "scaled_1e8": (lambda: tuple(1e8 * x for x in _random(32)), {}),
    # the JAX test's absolute bounds (1e-12 n) with scale = max|w| = 3
    "heavy_deflation": (_heavy_deflation,
                        {"leaf": 64, "wtol": 1e-12 / 3, "rtol": 1e-12 / 3, "otol": 1e-12}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_stedc_fp64_adversarial(case):
    make, kwargs = _CASES[case]
    d, e = make()
    _check(np.asarray(d, np.float64), np.asarray(e, np.float64), **kwargs)


@pytest.mark.parametrize(
    "case", ["random256", "identity_ties", "clustered_121", "decoupled", "wilkinson",
             "heavy_deflation"],
)
def test_stedc_fp32_adversarial(case):
    """fp32 (the main path's dtype, torch.linalg.eigh leaves, 35 secular
    steps): eigenvalues and residual within 64 eps32 max|w|, orthogonality
    within 1e-4 -- the fp32 pipeline's accuracy class, which the fp64
    refinement then absorbs."""
    make, kwargs = _CASES[case]
    d, e = (np.asarray(x, np.float32) for x in make())
    w, q = stedc(torch.tensor(d), torch.tensor(e), leaf=kwargs.get("leaf", 16))
    w, q = w.numpy().astype(np.float64), q.numpy().astype(np.float64)
    w_ref = scipy.linalg.eigh_tridiagonal(d.astype(np.float64), e.astype(np.float64),
                                          eigvals_only=True)
    tol = 64 * np.finfo(np.float32).eps * max(np.abs(w_ref).max(), 1.0)
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.abs(w - w_ref).max() < tol
    assert np.abs(t @ q - q * w[None, :]).max() < tol
    assert np.abs(q.T @ q - np.eye(d.shape[0])).max() < 1e-4
