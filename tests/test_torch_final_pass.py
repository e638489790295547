"""JAX's last two public arguments in the port, against the JAX package on
the CPU: ``refine_gevp_planar(final_pass=...)`` (ops/refine_planar.py) and
``sygst_blocked(n_buckets=...)`` (ops/sygst.py).

``final_pass`` is held in fp64, the port's native products against JAX's
``gemm='emulated'`` (on the CPU both are plain fp64 products): w within
1e-12 relative, vectors within 1e-9 by ``compare_vectors``, every B-norm
within 1e-12 of 1. The file makes four compiles of JAX's refinement (three
configurations and one ``jax.vmap``); ``sygst_blocked`` is JAX's eager
function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_tpu.ops.refine_planar import refine_gevp_planar as jax_refine_planar
from eigensolver_gpu_tpu.ops.sygst import sygst_blocked as jax_sygst_blocked
from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
from eigensolver_gpu_torch.ops.sygst import sygst_blocked
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    random_hpd_pair,
    random_spd_pair,
)

torch.set_num_threads(2)

T = lambda x: torch.tensor(np.ascontiguousarray(x))
N = lambda x: np.asarray(x)
PL = lambda x: (T(x.real), T(x.imag))
SIZE = 48


def _basis(pairs, seed):
    """Exact eigenvectors perturbed at the 1e-5 level and rounded to fp32,
    with perturbed eigenvalues: what the fp32 pipeline hands over."""
    rng = np.random.default_rng(seed)
    zs, ws = [], []
    for a, b in pairs:
        w, z = scipy.linalg.eigh(a, b)
        z = z + 1e-5 * (rng.standard_normal(z.shape) + 1j * rng.standard_normal(z.shape))
        zs.append(z.astype(np.complex64).astype(np.complex128))
        ws.append(w + 1e-5 * rng.standard_normal(w.shape))
    return np.stack(zs), np.stack(ws)


def _bnorm_err(b, x):
    """max_k |x_k^H B x_k - 1| (leading axes a batch)."""
    d = np.einsum("...ik,...ij,...jk->...k", x.conj(), b, x).real
    return float(np.abs(d - 1.0).max())


def _rel(got, want):
    return float(np.abs(N(got) - N(want)).max() / np.abs(N(want)).max())


CASES = {
    "all": dict(sweeps=2, coarse_first=False, sel=None),
    "sel": dict(sweeps=2, coarse_first=False, sel=(8, 24), extra_max=2),
    "coarse_first": dict(sweeps=2, coarse_first=True, sel=(8, 24), extra_max=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_final_pass_matches_jax(case):
    """n = 48, every column or the block (8, 24), fp64 sweeps or a coarse
    fp32 one first: w and the B-normalised block against JAX's."""
    kw = CASES[case]
    a, b = random_hpd_pair(SIZE, seed=160)
    z, w0 = _basis([(a, b)], 161)
    z, w0 = z[0], w0[0]
    w, (xr, xi) = refine_gevp_planar(PL(a), PL(b), PL(z), w0=T(w0), final_pass=True, **kw)
    jw, (jxr, jxi) = jax_refine_planar(
        (a.real, a.imag), (b.real, b.imag), (z.real, z.imag), w0=w0, final_pass=True,
        gemm="emulated", **kw)
    x = xr.numpy() + 1j * xi.numpy()
    assert _rel(w, jw) < 1e-12
    assert compare_vectors(x, N(jxr) + 1j * N(jxi)) < 1e-9
    assert _bnorm_err(b, x) < 1e-12
    lo, ms = kw["sel"] or (0, SIZE)
    assert x.shape == (SIZE, ms)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)[lo : lo + ms]
    assert np.abs(w.numpy() - w_ref).max() < 1e-12 * np.abs(w_ref).max()


def test_final_pass_batch_matches_vmap():
    """A batch of three through the port's leading axis against jax.vmap of
    JAX's function: w 1e-12, vectors 1e-9, B-norms 1e-12 from 1."""
    kw = CASES["sel"]
    pairs = [random_hpd_pair(SIZE, seed=162 + k) for k in range(3)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    z, w0 = _basis(pairs, 165)
    w, (xr, xi) = refine_gevp_planar(PL(a), PL(b), PL(z), w0=T(w0), final_pass=True, **kw)
    jw, (jxr, jxi) = jax.vmap(
        lambda ar, ai, br, bi, xr, xi, w0: jax_refine_planar(
            (ar, ai), (br, bi), (xr, xi), w0=w0, final_pass=True, gemm="emulated", **kw)
    )(*(jnp.asarray(v) for v in (a.real, a.imag, b.real, b.imag, z.real, z.imag, w0)))
    x = xr.numpy() + 1j * xi.numpy()
    jx = N(jxr) + 1j * N(jxi)
    assert w.shape == (3, kw["sel"][1])
    assert _rel(w, jw) < 1e-12
    for k in range(3):
        assert compare_vectors(x[k], jx[k]) < 1e-9
    assert _bnorm_err(b, x) < 1e-12


@pytest.mark.parametrize("gemm", ["native", "ozaki"])
def test_final_pass_false_is_the_default(gemm):
    """final_pass=False gives the same bits as the call without it."""
    a, b = random_hpd_pair(SIZE, seed=166)
    z, w0 = _basis([(a, b)], 167)
    args = (PL(a), PL(b), PL(z[0]))
    kw = dict(sweeps=2, sel=(8, 24), w0=T(w0[0]), extra_max=2, gemm=gemm)
    w0_, (x0r, x0i) = refine_gevp_planar(*args, **kw)
    w1_, (x1r, x1i) = refine_gevp_planar(*args, final_pass=False, **kw)
    assert torch.equal(w0_, w1_) and torch.equal(x0r, x1r) and torch.equal(x0i, x1i)


@pytest.mark.parametrize("n_buckets", [1, 4])
@pytest.mark.parametrize("cplx", [False, True])
def test_sygst_blocked_n_buckets_matches_jax(cplx, n_buckets):
    """n = 64 in blocks of 16: C within 1e-12 of JAX's with the same
    n_buckets, and the port's C the same bits for 1, 2, 4 and 7 buckets."""
    a, b = (random_hpd_pair if cplx else random_spd_pair)(64, seed=168)
    u = np.linalg.cholesky(b).conj().T
    c = sygst_blocked(T(a), T(u), nb=16, n_buckets=n_buckets)
    jc = jax_sygst_blocked(jnp.asarray(a), jnp.asarray(u), nb=16, n_buckets=n_buckets)
    assert _rel(c, jc) < 1e-12
    for other in (1, 2, 4, 7):
        assert torch.equal(sygst_blocked(T(a), T(u), nb=16, n_buckets=other), c)
