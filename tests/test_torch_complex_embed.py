"""The port's complex embedding (eigensolver_gpu_torch/ops/complex_embed.py)
and its planar Jacobi (ops/jacobi.jacobi_eigh_planar) against the JAX
package's, on the CPU.

jacobi_eigh_planar at m = 8 and 16 on random, clustered and exactly
degenerate Hermitian matrices, and on a batch (against jax.vmap):
eigenvalues within 1e-13 of JAX relative to the largest, A V = V diag(w)
and V^H V = I to 1e-13 m, vectors phase-insensitively within 1e-10 of JAX
where the spectrum is simple, and for a degenerate cluster its invariant
subspace (the projector V_c V_c^H) within 1e-10 of JAX's. Odd m raises.

The embedded solves are held to JAX's outputs and to the bars of JAX's
tests/test_complex_embed.py: the three cases there (random pairs at
(48, 1..12) and (64, 3..20): eigenvalues within 1e-10 n of scipy,
ge_residual < 1e-12, B-orthonormality < 1e-9 n; the QE-style clustered
spectrum: 1e-9 n and 1e-11; the exactly degenerate spectrum: 1e-10 n, full
rank, B-orthonormality < 1e-9 n, ge_residual < 1e-12), plus a non-positive-
definite B (JAX's info, no exception). Eigenvalues against JAX's within the
same bars; vectors against JAX's phase-insensitively within 1e-8 for the
random pairs, and by the clusters' subspaces (1e-8) where eigenvalues are
degenerate. The batched solve takes the batched real two-stage route
(two_stage_min_n = 32, band 8 at a real size of 48) and is held against
JAX's batched solve with the same configuration and against the port's
unbatched solve of each item (eigenvalues 1e-12 n, vectors 1e-8)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.ops.jacobi import jacobi_eigh_planar as jax_jacobi_planar
from eigensolver_gpu_torch import SolverConfig
from eigensolver_gpu_torch.ops import complex_embed as t_ce
from eigensolver_gpu_torch.ops.jacobi import jacobi_eigh_planar
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    ge_residual,
    orthonormality_error,
    qe_style_pair,
    random_hpd_pair,
)
from test_torch_batched_helpers import pair_batch, planes

# the JAX ops package re-exports functions under its modules' names
j_ce = importlib.import_module("eigensolver_gpu_tpu.ops.complex_embed")

torch.set_num_threads(2)


def _herm(m, seed, kind):
    """An m x m Hermitian matrix: random, with a tight cluster (three
    eigenvalues 1e-9 apart), or with an exactly 3-fold eigenvalue."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    if kind == "random":
        return (t + t.conj().T) / 2
    q, _ = np.linalg.qr(t)
    w = np.sort(rng.standard_normal(m))
    w[2:5] = w[2] + (1e-9 * np.arange(3) if kind == "clustered" else 0.0)
    a = (q * w[None, :]) @ q.conj().T
    return (a + a.conj().T) / 2


def _groups(w, gap=1e-6):
    """Index ranges of w (ascending) whose neighbours lie within gap."""
    cuts = [0] + [i + 1 for i in range(len(w) - 1) if w[i + 1] - w[i] > gap] + [len(w)]
    return [slice(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]


def _same_subspaces(w, z, jz, tol, b=None):
    """Each cluster of w spans the same B-invariant subspace in z and jz:
    the B-projectors Z_c Z_c^H B agree within tol."""
    bm = np.eye(z.shape[0]) if b is None else b
    for g in _groups(w):
        p, jp = z[:, g] @ z[:, g].conj().T @ bm, jz[:, g] @ jz[:, g].conj().T @ bm
        assert np.abs(p - jp).max() < tol


@pytest.mark.parametrize("kind", ["random", "clustered", "degenerate"])
@pytest.mark.parametrize("m", [8, 16])
def test_jacobi_eigh_planar_matches_jax(m, kind):
    a = _herm(m, 40 + m, kind)
    w, (vr, vi) = jacobi_eigh_planar(torch.tensor(a.real.copy()), torch.tensor(a.imag.copy()))
    jw, (jvr, jvi) = jax_jacobi_planar(jnp.asarray(a.real), jnp.asarray(a.imag))
    w, v = w.numpy(), vr.numpy() + 1j * vi.numpy()
    jv = np.asarray(jvr) + 1j * np.asarray(jvi)
    scale = np.abs(np.linalg.eigvalsh(a)).max()
    assert w.shape == (m,) and v.shape == (m, m) and np.all(np.diff(w) >= 0)
    assert np.abs(w - np.asarray(jw)).max() < 1e-13 * scale
    assert np.abs(a @ v - v * w[None, :]).max() < 1e-13 * m * scale
    assert np.abs(v.conj().T @ v - np.eye(m)).max() < 1e-13 * m
    if kind == "random":
        assert compare_vectors(v, jv) < 1e-10
    else:
        _same_subspaces(w, v, jv, 1e-10)


def test_jacobi_eigh_planar_batched_matches_vmapped_jax():
    """Leading batch axes (2, 3): each item as jax.vmap of JAX's and as the
    port's call on that item alone; odd m raises."""
    m = 8
    a = np.stack([_herm(m, 60 + k, kind) for k, kind in
                  enumerate(["random", "clustered", "degenerate"] * 2)]).reshape(2, 3, m, m)
    w, (vr, vi) = jacobi_eigh_planar(torch.tensor(a.real.copy()), torch.tensor(a.imag.copy()))
    jw, _ = jax.vmap(jax.vmap(jax_jacobi_planar))(jnp.asarray(a.real), jnp.asarray(a.imag))
    assert w.shape == (2, 3, m) and vr.shape == vi.shape == (2, 3, m, m)
    assert np.abs(w.numpy() - np.asarray(jw)).max() < 1e-13 * np.abs(np.asarray(jw)).max()
    for i in range(2):
        for k in range(3):
            ow, (ovr, ovi) = jacobi_eigh_planar(torch.tensor(a[i, k].real.copy()),
                                                torch.tensor(a[i, k].imag.copy()))
            assert np.abs(ow.numpy() - w[i, k].numpy()).max() < 1e-13 * m
            v = vr[i, k].numpy() + 1j * vi[i, k].numpy()
            assert np.abs(a[i, k] @ v - v * w[i, k].numpy()[None, :]).max() < 1e-12
            _same_subspaces(w[i, k].numpy(), v, ovr.numpy() + 1j * ovi.numpy(), 1e-10)
    with pytest.raises(ValueError):
        jacobi_eigh_planar(torch.zeros(5, 5, dtype=torch.float64),
                           torch.zeros(5, 5, dtype=torch.float64))


def test_embed_herm_matches_jax():
    a, _ = random_hpd_pair(12, seed=7)
    got = t_ce.embed_herm(torch.tensor(a.real.copy()), torch.tensor(a.imag.copy()))
    assert np.array_equal(got.numpy(), np.asarray(j_ce.embed_herm(a.real, a.imag)))
    batch = t_ce.embed_herm(*(torch.tensor(np.stack([x] * 2)) for x in (a.real, a.imag)))
    assert batch.shape == (2, 24, 24) and torch.equal(batch[1], got)


def _degenerate(n=64):
    """The exactly degenerate spectrum of JAX's tests/test_complex_embed.py."""
    rng = np.random.default_rng(72)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(t)
    w0 = np.sort(rng.standard_normal(n))
    w0[3:9] = w0[3]  # 6-fold degenerate cluster inside the range
    w0[20:24] = w0[20]  # and a second one
    a = (q * w0[None, :]) @ q.conj().T
    return (a + a.conj().T) / 2, np.eye(n, dtype=complex), w0


def _both(a, b, il, iu):
    """The port's and JAX's zhegvdx_via_embedding of one pair, as numpy
    (w, z, info)."""
    res = t_ce.zhegvdx_via_embedding(a, b, il=il, iu=iu, device="cpu")
    jw, jzr, jzi, jinfo = j_ce.zhegvdx_via_embedding(a, b, il=il, iu=iu)
    return ((res.w.numpy(), res.zr.numpy() + 1j * res.zi.numpy(), int(res.info)),
            (np.asarray(jw), np.asarray(jzr) + 1j * np.asarray(jzi), int(jinfo)))


@pytest.mark.parametrize("n,il,iu", [(48, 1, 12), (64, 3, 20)])
def test_embedded_matches_scipy_and_jax(n, il, iu):
    a, b = random_hpd_pair(n, seed=70)
    (w, z, info), (jw, jz, jinfo) = _both(a, b, il, iu)
    assert info == jinfo == 0
    assert w.shape == (iu - il + 1,) and z.shape == (n, iu - il + 1)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_ref[il - 1 : iu]).max() < 1e-10 * n
    assert np.abs(w - jw).max() < 1e-10 * n
    assert ge_residual(a, b, w, z) < 1e-12
    assert orthonormality_error(z, b) < 1e-9 * n
    assert compare_vectors(z, jz) < 1e-8


def test_embedded_qe_spectrum():
    n = 96
    a, b = qe_style_pair(n, seed=71)
    (w, z, info), (jw, jz, jinfo) = _both(a, b, 1, 24)
    assert info == jinfo == 0
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_ref[:24]).max() < 1e-9 * n
    assert np.abs(w - jw).max() < 1e-9 * n
    assert ge_residual(a, b, w, z) < 1e-11
    _same_subspaces(w, z, jz, 1e-8, b)


def test_embedded_exactly_degenerate_spectrum():
    """Exactly multiple eigenvalues through the embedding: B-orthonormal
    eigenpairs of full rank, as in JAX's test, and the clusters' subspaces
    as JAX's."""
    n, m = 64, 32
    a, b, w0 = _degenerate(n)
    (w, z, info), (jw, jz, jinfo) = _both(a, b, 1, m)
    assert info == jinfo == 0
    assert np.abs(w - w0[:m]).max() < 1e-10 * n
    assert np.abs(w - jw).max() < 1e-10 * n
    assert orthonormality_error(z, b) < 1e-9 * n
    assert np.linalg.matrix_rank(z, tol=1e-6) == m
    assert ge_residual(a, b, w, z) < 1e-12
    _same_subspaces(w, z, jz, 1e-8, b)


def test_embedded_non_pd_b_gives_jax_info():
    """B not positive definite: with the bad pivot first, info 1 as JAX
    gives it, no exception; with it at row 10, info 10, the column of the
    real driver's devInfo on M(B) (JAX's real path on the CPU reports 1
    there, ROADMAP.md C)."""
    a, b = random_hpd_pair(48, seed=70)
    for row, want in ((0, 1), (9, 10)):
        bad = b.copy()
        bad[row, row] = -50.0
        (_, _, info), (_, _, jinfo) = _both(a, bad, 1, 12)
        assert info == want and jinfo == 1


def test_rank_deficient_compression_sets_info_past_n():
    """The extraction's gram: the planar Cholesky's ``fail`` is JAX's
    (1-based column of the first non-positive pivot) on a zero gram, a
    rank-2 gram and one with a negative pivot; a rank-deficient
    compression (zero columns in y) gives gfail 1, which the driver reports
    as info = n + gfail when B factored, an earlier B failure first."""
    from eigensolver_gpu_tpu.ops.planar import _pchol_base as jax_pchol_base
    from eigensolver_gpu_torch.ops.pchol import _pchol_base

    rng = np.random.default_rng(6)
    t = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
    grams = [np.zeros((4, 4), complex), t @ t.conj().T,
             np.diag([2.0, 1.0, -3.0, 1.0]).astype(complex)]
    for g, want in zip(grams, (1, 3, 3)):
        fail = _pchol_base(torch.tensor(g.real.copy()), torch.tensor(g.imag.copy()), 4)[2]
        jfail = jax_pchol_base(jnp.asarray(g.real), jnp.asarray(g.imag), 4)[2]
        assert int(fail) == int(jfail) == want
    n, m = 12, 3
    a, b = random_hpd_pair(n, seed=5)
    ar, ai, br, bi = (torch.tensor(x.copy()) for x in (a.real, a.imag, b.real, b.imag))
    gfail = t_ce._extract_invariant(torch.zeros(2 * n, 2 * m, dtype=torch.float64),
                                    (ar, ai), (br, bi), m)[3]
    assert int(gfail) == 1

    def solve(info):
        return lambda ma, mb, il, iu, cfg: (None, torch.zeros(ma.shape[-1], iu - il + 1,
                                                              dtype=ma.dtype),
                                            torch.tensor(info, dtype=torch.int32))

    args = (ar, ai, br, bi, 1, m, SolverConfig())
    assert int(t_ce._embedded(*args, solve(0)).info) == n + 1
    assert int(t_ce._embedded(*args, solve(5)).info) == 5


def test_argument_checks():
    ar, ai, br, bi = planes(*pair_batch(2, 8, seed=3))
    with pytest.raises(ValueError):
        t_ce.zhegvdx_embedded(ar, ai, br, bi)  # a batch: the batched entry
    with pytest.raises(ValueError):
        t_ce.zhegvdx_embedded_batched(ar[0], ai[0], br[0], bi[0])
    with pytest.raises(ValueError):
        t_ce.zhegvdx_embedded(ar[0], ai[0], br[0], bi[0], il=0, iu=2)


EMB = dict(two_stage_min_n=32, band=8)  # fp64 'auto': the real 48 x 48 solve is two-stage


def test_embedded_batched_is_one_batched_two_stage_solve(monkeypatch):
    """zhegvdx_embedded_batched on 3 x n = 24 (real 48), iu = 6: one
    sygvdx_batched call on the (3, 48, 48) embeddings, whose chase is one
    bulge_chase_kernel call on the batch; held against JAX's batched solve
    with the same configuration, scipy, and the port's unbatched
    zhegvdx_embedded of each item."""
    import eigensolver_gpu_torch.parallel.sharded as sharded
    from eigensolver_gpu_torch.ops import chase

    n, iu, batch = 24, 6, 3
    a, b = pair_batch(batch, n, seed=110)
    args = planes(a, b)
    cfg = SolverConfig(**EMB)
    log = {"solve": [], "chase": []}
    solve, kernel = sharded.sygvdx_batched, chase.bulge_chase_kernel
    monkeypatch.setattr(sharded, "sygvdx_batched", lambda x, *r, **k: log["solve"].append(
        tuple(x.shape)) or solve(x, *r, **k))
    monkeypatch.setattr(chase, "bulge_chase_kernel", lambda x, *r, **k: log["chase"].append(
        tuple(x.shape)) or kernel(x, *r, **k))
    res = t_ce.zhegvdx_embedded_batched(*args, il=1, iu=iu, cfg=cfg)
    monkeypatch.undo()
    assert log == {"solve": [(batch, 2 * n, 2 * n)], "chase": [(batch, 2 * n, 16)]}
    assert res.w.shape == (batch, iu) and res.zr.shape == res.zi.shape == (batch, n, iu)
    assert res.info.dtype == torch.int32 and res.info.tolist() == [0] * batch
    jw, jzr, jzi, jinfo = j_ce.zhegvdx_embedded_batched(
        *(jnp.asarray(x.numpy()) for x in args), il=1, iu=iu, cfg=JaxConfig(**EMB))
    assert np.asarray(jinfo).tolist() == [0] * batch
    w, z = res.w.numpy(), res.zr.numpy() + 1j * res.zi.numpy()
    jz = np.asarray(jzr) + 1j * np.asarray(jzi)
    for k in range(batch):
        w_ref = scipy.linalg.eigh(a[k], b[k], eigvals_only=True)[:iu]
        assert np.abs(w[k] - w_ref).max() < 1e-10 * n
        assert np.abs(w[k] - np.asarray(jw)[k]).max() < 1e-10 * n
        assert ge_residual(a[k], b[k], w[k], z[k]) < 1e-12
        assert compare_vectors(z[k], jz[k]) < 1e-8
        one = t_ce.zhegvdx_embedded(*(x[k] for x in args), il=1, iu=iu, cfg=cfg)
        assert int(one.info) == 0
        assert np.abs(one.w.numpy() - w[k]).max() < 1e-12 * n
        assert compare_vectors(z[k], one.zr.numpy() + 1j * one.zi.numpy()) < 1e-8
