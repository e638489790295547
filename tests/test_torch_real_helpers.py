"""Helpers shared by tests/test_torch_real_pipeline.py and
tests/test_torch_real_mixed.py: one numpy pair through the same driver of
the JAX package and of the port (eigensolver_gpu_torch), and the checks
that hold the port's result to JAX's."""

import numpy as np
import scipy.linalg
import torch

import eigensolver_gpu_tpu as jax_eig
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.utils.convert import dense_from_numpy
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    ge_residual,
    random_hpd_pair,
    random_spd_pair,
)


def make_pair(n, dtype, seed=70):
    cplx = np.dtype(dtype).kind == "c"
    a, b = (random_hpd_pair if cplx else random_spd_pair)(n, seed=seed)
    return a.astype(dtype), b.astype(dtype)


def is32(dtype):
    return np.dtype(dtype) in (np.dtype(np.float32), np.dtype(np.complex64))


def check_against_jax(fn, n, dtype, kw, il, iu):
    """Run driver ``fn`` of both packages on one pair and hold the port's
    result to JAX's: eigenvalues within 1e-11 ||A|| (fp64) / 1e-4 ||A||
    (fp32), vectors phase-insensitively within 1e-8 (fp64) / 5e-2 (fp32,
    eps32 ||A|| / gap), ge_residual < 1e-12 (fp64) / 1e-6 (fp32), the
    same info, the JAX shapes and dtypes."""
    a, b = make_pair(n, dtype)
    ta, tb = dense_from_numpy(a, b, device="cpu")
    if fn == "syevdx":
        b = np.eye(n, dtype=dtype)
        w, z = eig.syevdx(ta, il=il, iu=iu, cfg=eig.SolverConfig(**kw))
        jw, jz = jax_eig.syevdx(a, il=il, iu=iu, cfg=jax_eig.SolverConfig(**kw))
    else:
        w, z, info = getattr(eig, fn)(ta, tb, il=il, iu=iu, cfg=eig.SolverConfig(**kw))
        jw, jz, jinfo = getattr(jax_eig, fn)(a, b, il=il, iu=iu, cfg=jax_eig.SolverConfig(**kw))
        assert int(info) == int(jinfo) == 0
        assert info.dtype == torch.int32 and info.ndim == 0 and info.device == ta.device
    w, z, jw, jz = w.numpy(), z.resolve_conj().numpy(), np.asarray(jw), np.asarray(jz)
    m = iu - il + 1
    assert w.shape == jw.shape == (m,) and z.shape == jz.shape == (n, m)
    assert w.dtype == jw.dtype and z.dtype == jz.dtype == np.dtype(dtype)
    lo = is32(dtype)
    w_all = scipy.linalg.eigh(a.astype(np.complex128), b.astype(np.complex128), eigvals_only=True)
    scale = np.abs(w_all).max()
    assert np.abs(w - jw).max() < (1e-4 if lo else 1e-11) * scale
    assert np.abs(w - w_all[il - 1 : iu]).max() < (1e-4 if lo else 1e-11) * scale
    assert ge_residual(a, b, w, z) < (1e-6 if lo else 1e-12)
    assert compare_vectors(z, jz) < (5e-2 if lo else 1e-8)
    return w, z
