"""Test fixtures and accuracy metrics, numpy only (the port's own copy of
the pieces of eigensolver_gpu_tpu/utils/testing.py it needs).

* ``random_spd_pair`` / ``random_hpd_pair`` / ``qe_style_pair`` mirror the
  reference's ``create_random_symmetric_pd`` (test_dsygvdx.F90:28-64),
  ``create_random_hermetian_pd`` (test_driver/test_zhegvdx.F90:28-66)
  and a Quantum-ESPRESSO-style clustered spectrum; with the same seed
  they give the same arrays as the JAX package's fixtures.
* ``compare_values`` is the relative L2 comparison of eigenvalues of
  test_driver/toolbox.F90:36-78, ``compare_vectors`` the phase-insensitive
  matrix comparison of toolbox.F90:80-177, ``ge_residual`` and
  ``std_residual`` the normalized generalized and standard residuals,
  ``orthonormality_error`` the B-orthonormality defect.
"""

from __future__ import annotations

import numpy as np


def random_spd_pair(n, seed=0, dtype=np.float64, diag_shift=None):
    """Random (A symmetric, B SPD) pair, mirroring test_dsygvdx.F90:28-64."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)).astype(dtype)
    a = (t + t.T) / 2
    t2 = rng.standard_normal((n, n)).astype(dtype)
    shift = n if diag_shift is None else diag_shift
    b = t2 @ t2.T / n + shift / n * np.eye(n, dtype=dtype)
    return a, b


def random_hpd_pair(n, seed=0, dtype=np.complex128, diag_shift=None):
    """Random (A Hermitian, B HPD) pair, mirroring test_zhegvdx.F90:28-66."""
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(dtype)
    a = (t + t.conj().T) / 2
    t2 = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(dtype)
    shift = n if diag_shift is None else diag_shift
    b = t2 @ t2.conj().T / n + shift / n * np.eye(n, dtype=dtype)
    return a, b


def qe_style_pair(n, seed=0, dtype=np.complex128, decay=0.5):
    """Hermitian pair with a clustered low spectrum (occupied bands) and a
    spread-out tail, built by conjugating a chosen spectrum with a random
    unitary. ``decay`` is accepted and not read, as in the JAX fixture, so
    one call drives both packages."""
    rng = np.random.default_rng(seed)
    lam = np.concatenate(
        [
            -10.0 + 0.05 * rng.standard_normal(n // 4),
            np.sort(rng.uniform(0.0, 100.0, n - n // 4)),
        ]
    )
    iscomplex = np.issubdtype(dtype, np.complexfloating)
    g = rng.standard_normal((n, n))
    if iscomplex:
        g = g + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(g)
    a = (q * lam) @ q.conj().T
    a = (a + a.conj().T) / 2
    t2 = rng.standard_normal((n, n))
    if iscomplex:
        t2 = t2 + 1j * rng.standard_normal((n, n))
    t2 = t2.astype(dtype)
    b = t2 @ t2.conj().T / n + np.eye(n, dtype=dtype)
    return a.astype(dtype), b


def compare_values(x, y):
    """Relative L2 error of eigenvalues, compared directly."""
    x = np.asarray(x)
    y = np.asarray(y)
    denom = np.linalg.norm(y)
    return float(np.linalg.norm(x - y) / (denom if denom else 1.0))


def compare_vectors(z1, z2):
    """Relative L2 distance of |z1| and |z2| (absorbs column phases)."""
    z1 = np.abs(np.asarray(z1))
    z2 = np.abs(np.asarray(z2))
    denom = np.linalg.norm(z2)
    return float(np.linalg.norm(z1 - z2) / (denom if denom else 1.0))


def ge_residual(a, b, w, z):
    """max_k ||A z_k - w_k B z_k||_2 / (n * ||A||_1)."""
    a = np.asarray(a)
    b = np.asarray(b)
    w = np.asarray(w)
    z = np.asarray(z)
    n = a.shape[0]
    r = a @ z - (b @ z) * w[None, :]
    anorm = np.linalg.norm(a, ord=1)
    return float(np.max(np.linalg.norm(r, axis=0)) / (n * anorm))


def std_residual(a, w, z):
    """max_k ||A z_k - w_k z_k||_2 / (n * ||A||_1) for the standard problem."""
    a = np.asarray(a)
    r = a @ np.asarray(z) - np.asarray(z) * np.asarray(w)[None, :]
    anorm = np.linalg.norm(a, ord=1)
    return float(np.max(np.linalg.norm(r, axis=0)) / (a.shape[0] * anorm))


def orthonormality_error(z, b=None):
    """||Z^H B Z - I||_max (B-orthonormality for the generalized problem)."""
    z = np.asarray(z)
    g = z.conj().T @ (np.asarray(b) @ z if b is not None else z)
    return float(np.max(np.abs(g - np.eye(z.shape[1], dtype=g.dtype))))
