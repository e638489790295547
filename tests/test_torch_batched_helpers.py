"""Helpers shared by the batched driver tests (tests/test_torch_batched_*.py):
numpy batches of distinct pairs, and the checks that hold a batched
result to jax.vmap of the JAX driver, to scipy and to the port's
unbatched solve of each item."""

import numpy as np
import scipy.linalg
import torch

import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    ge_residual,
    random_hpd_pair,
    random_spd_pair,
)

MIXED = dict(compute_dtype="float32", refine_iters=2)
MODES = {"mp": MIXED, "fp64": {}}
LEAF = 16  # as the JAX package's tests/test_batched.py


def pair_batch(batch, n, seed, cplx=True):
    """(batch, n, n) A and B: item k is random_{hpd,spd}_pair(n, seed + k)."""
    make = random_hpd_pair if cplx else random_spd_pair
    pairs = [make(n, seed=seed + k) for k in range(batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def planes(a, b):
    """The four contiguous fp64 CPU planes of a complex batch."""
    t = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float64)
    return t(a.real), t(a.imag), t(b.real), t(b.imag)


def as_complex(zr, zi):
    return zr.numpy() + 1j * zi.numpy()


def check_items(a, b, w, z, info, iu, jw=None, jinfo=None, skip=()):
    """Every item: eigenvalues within 1e-10 n of scipy (and of the JAX
    result ``jw`` when given), ge_residual < 1e-12, info exact (0, or
    JAX's); items in ``skip`` (non-PD) are held by info only."""
    batch, n = a.shape[:2]
    info = np.asarray(info)
    assert info.shape == (batch,) and info.dtype == np.int32
    if jinfo is not None:
        assert info.tolist() == np.asarray(jinfo).tolist()
    for k in range(batch):
        if k in skip:
            assert info[k] > 0
            continue
        assert info[k] == 0
        w_ref = scipy.linalg.eigh(a[k], b[k], eigvals_only=True)[:iu]
        assert np.abs(w[k] - w_ref).max() < 1e-10 * n
        if jw is not None:
            assert np.abs(w[k] - np.asarray(jw)[k]).max() < 1e-10 * n
        assert ge_residual(a[k], b[k], w[k], z[k]) < 1e-12


def check_against_single(w, z, single, n):
    """A batched item against the port's unbatched solve of it:
    eigenvalues within 1e-12 n, vectors phase-insensitively within 1e-8."""
    sw, sz = single
    assert np.abs(w - sw).max() < 1e-12 * n
    assert compare_vectors(z, sz) < 1e-8


def planar_single(a, b, iu, cfg):
    """The port's unbatched planar solve of one complex pair."""
    res = eig.zhegvdx_planar(*planes(a, b), il=1, iu=iu, cfg=cfg)
    return res.w.numpy(), as_complex(res.zr, res.zi), int(res.info)
