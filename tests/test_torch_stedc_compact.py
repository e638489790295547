"""The port's stedc merge (eigensolver_gpu_torch/ops/stedc.py): JAX's
deflation-aware ``compact`` assembly and JAX's stop rule for the secular
iteration's live lanes (deflated lanes count as done), against the JAX
package's ``_merge_pair`` and ``stedc`` on the CPU in fp64, and against
scipy and a run held to the sweep ceiling in fp32 and fp64.

Merges are made to deflate to each of the four gemm buckets: blocks whose
eigenvectors reach the coupled boundary through k of them only, so 2k
poles stay alive. Eigenvalues agree with JAX to 1e-12 relative (the
stop rule is read every ``STOP_EVERY`` sweeps, and sweeps past JAX's stop
move roots only inside brackets collapsed to eps), vectors
phase-insensitively to 1e-10.
"""

import functools
import sys
from unittest import mock

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import eigensolver_gpu_tpu.ops.stedc  # noqa: F401
from eigensolver_gpu_tpu.ops.stedc import stedc as jax_stedc
from eigensolver_gpu_torch.ops import stedc as stedc_mod
from eigensolver_gpu_torch.ops.stedc import _buckets, _merge_pair, _secular_iters, stedc
from eigensolver_gpu_torch.utils.testing import compare_vectors

torch.set_num_threads(2)

# the JAX ops package re-exports stedc under its module's name
jax_stedc_mod = sys.modules["eigensolver_gpu_tpu.ops.stedc"]

M = 256  # each half of the merge; n2 = 512, buckets 128, 256, 384, 512


def _half(k, seed, boundary_last):
    """Eigenpairs (d, Q) of an M x M block whose eigenvectors reach the
    merge boundary (its last row, or its first) through k of them only: Q
    is the identity but for a random orthogonal k x k block at that
    boundary, d distinct values in [-2, 2]."""
    rng = np.random.default_rng(seed)
    h, _ = np.linalg.qr(rng.standard_normal((k, k)))
    q = np.eye(M)
    if boundary_last:
        q[M - k :, M - k :] = h
    else:
        q[:k, :k] = h
    return rng.uniform(-2.0, 2.0, M), q


def _merge_args(k, seed=0):
    w1, q1 = _half(k, seed, True)
    w2, q2 = _half(k, seed + 1, False)
    gap_scale = max(np.abs(np.concatenate([w1, w2])).max(), 1.0)
    return w1, q1, w2, q2, 0.7, gap_scale


def _port(args, compact):
    w1, q1, w2, q2, beta, gs = args
    b = lambda x: torch.tensor(np.asarray(x, np.float64))[None]
    w, q = _merge_pair(b(w1), b(q1), b(w2), b(q2), b(beta), b(gs), compact=compact)
    return w[0].numpy(), q[0].numpy()


def _merged_matrix(args):
    """The matrix the merge diagonalizes: blockdiag(Q1 D1 Q1^T, Q2 D2 Q2^T)
    + |beta| v v^T with v = [sign(beta) e_last, e_first]."""
    w1, q1, w2, q2, beta, _ = args
    t = scipy.linalg.block_diag((q1 * w1) @ q1.T, (q2 * w2) @ q2.T)
    v = np.zeros(2 * M)
    v[M - 1], v[M] = np.sign(beta), 1.0
    return t + abs(beta) * np.outer(v, v)


# alive counts about 2k: one case for each bucket of n2 = 512
_BUCKET_CASES = {128: 50, 256: 100, 384: 150, 512: 240}


@pytest.mark.parametrize("bucket", sorted(_BUCKET_CASES))
def test_compact_merge_matches_jax_in_each_bucket(bucket):
    """_merge_pair(compact=True) in each bucket against JAX's (eager,
    unbatched, its lax.switch): eigenvalues 1e-12 relative, vectors 1e-10,
    and the bucket the port chose from its alive count."""
    args = _merge_args(_BUCKET_CASES[bucket], seed=bucket)
    w, q = _port(args, compact=True)
    assert stedc_mod._merge_pair.bucket == [bucket]
    assert stedc_mod._merge_pair.alive == [2 * _BUCKET_CASES[bucket]]
    assert _buckets(2 * M) == [128, 256, 384, 512]
    jw, jq = jax_stedc_mod._merge_pair(*(jnp.asarray(a) for a in args), compact=True)
    scale = np.abs(w).max()
    assert np.abs(w - np.asarray(jw)).max() < 1e-12 * scale
    assert compare_vectors(q, np.asarray(jq)) < 1e-10
    t = _merged_matrix(args)
    assert np.abs(t @ q - q * w).max() < 1e-12 * scale * 2 * M
    assert np.abs(q.T @ q - np.eye(2 * M)).max() < 1e-12 * 2 * M


@pytest.mark.parametrize("bucket", sorted(_BUCKET_CASES))
def test_compact_merge_matches_the_full_assembly(bucket):
    """compact=True against the port's compact=False: the same eigenvalues
    (the flag changes only the assembly), vectors within 1e-13 (the full
    gemm adds the dead rows' exact zeros)."""
    args = _merge_args(_BUCKET_CASES[bucket], seed=bucket + 1)
    w, q = _port(args, compact=True)
    w0, q0 = _port(args, compact=False)
    assert np.array_equal(w, w0)
    assert np.abs(q - q0).max() < 1e-13


def test_batched_compact_merge_gives_each_item_its_bucket():
    """Four merges in one call, one in each bucket: every item its own
    bucket (as under JAX's vmap) and its unbatched compact merge's result
    (1e-13; the batch runs until its last lane is done)."""
    cases = [_merge_args(k, seed=10 + k) for k in (240, 50, 150, 100)]
    b = lambda i: torch.tensor(np.stack([np.asarray(c[i], np.float64) for c in cases]))
    w, q = _merge_pair(b(0), b(1), b(2), b(3), b(4), b(5), compact=True)
    assert stedc_mod._merge_pair.bucket == [512, 128, 384, 256]
    for k, args in enumerate(cases):
        w1, q1 = _port(args, compact=True)
        assert np.abs(w[k].numpy() - w1).max() < 1e-13 * np.abs(w1).max()
        assert np.abs(q[k].numpy() - q1).max() < 1e-13


def _random(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _heavy_deflation():
    n = 384  # 6 leaves of 64: the fold merge 4 + 2 and two compact levels
    d = np.repeat(np.linspace(1.0, 3.0, 8), n // 8)
    e = np.full(n - 1, 1e-13)
    e[:: n // 8] = 0.5
    return d, e


def _graded():
    n = 256
    d = np.logspace(0, -12, n)
    e = 1e-3 * d[:-1] * np.random.default_rng(2).standard_normal(n - 1)
    return d, e


def _decoupled():
    rng = np.random.default_rng(3)
    d, e = rng.standard_normal(320), rng.standard_normal(319)
    e[10] = e[131] = e[250] = 0.0
    return d, e


_STEDC_CASES = {
    "random256": (lambda: _random(256, 256), 32),
    "random320_fold": (lambda: _random(320, 7), 64),  # 5 leaves: 4 + 1
    "heavy_deflation": (_heavy_deflation, 64),
    "graded": (_graded, 32),
    "decoupled": (_decoupled, 64),
    "clustered_121": (lambda: (2.0 * np.ones(256), np.ones(255)), 32),
}


@pytest.mark.parametrize("case", sorted(_STEDC_CASES))
def test_stedc_matches_jax_on_adversarial_spectra(case):
    """stedc in fp64 (Jacobi leaves in both packages) with the compact top
    merges and the stop rule: eigenvalues within 1e-12 n of JAX's
    (relative to max |w|), vectors phase-insensitively within 1e-8 where
    the spectrum is simple, residual and orthogonality at JAX's level."""
    make, leaf = _STEDC_CASES[case]
    d, e = (np.asarray(x, np.float64) for x in make())
    n = d.shape[0]
    w, q = stedc(torch.tensor(d), torch.tensor(e), leaf=leaf)
    jw, jq = jax_stedc(jnp.asarray(d), jnp.asarray(e), leaf=leaf)
    w, q, jw, jq = w.numpy(), q.numpy(), np.asarray(jw), np.asarray(jq)
    scale = max(np.abs(jw).max(), 1.0)
    assert np.abs(w - jw).max() < 1e-12 * scale * n
    assert stedc.compact, "no compact merge ran"
    if np.diff(jw).min() > 1e-6 * scale:
        assert compare_vectors(q, jq) < 1e-8
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    res = lambda w, q: np.abs(t @ q - q * w).max()
    assert res(w, q) < 4 * res(jw, jq) + 1e-13 * scale * n
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-11 * n


def test_stedc_fp32_matches_jax():
    """fp32 (torch.linalg.eigh leaves in both): eigenvalues within 64 eps32
    max|w| of JAX's, the fp32 pipeline's class."""
    d, e = (x.astype(np.float32) for x in _random(512, 5))
    w, _ = stedc(torch.tensor(d), torch.tensor(e))
    jw, _ = jax_stedc(jnp.asarray(d), jnp.asarray(e))
    tol = 64 * np.finfo(np.float32).eps * np.abs(np.asarray(jw)).max()
    assert np.abs(w.numpy() - np.asarray(jw)).max() < tol


def test_batched_stedc_items_in_different_buckets_match_their_solves():
    """A batch of four n = 384 problems (the discrete Laplacian, whose poles
    all stay alive, the same with diagonal noise of 1 and 2, and heavy
    deflation): the compact merges give each item its own bucket, and each
    item equals its unbatched solve (eigenvalues 1e-13 relative, vectors
    1e-10)."""
    rng = np.random.default_rng(9)
    lap = lambda s: (s * rng.standard_normal(384), np.ones(383))
    probs = [lap(0.0), lap(1.0), lap(2.0), _heavy_deflation()]
    d = torch.tensor(np.stack([p[0] for p in probs]))
    e = torch.tensor(np.stack([p[1] for p in probs]))
    w, q = stedc(d, e, leaf=64)
    top = stedc.compact[-1]
    assert top[0] == 384 and len(set(top[2])) > 1, top
    for k, (dk, ek) in enumerate(probs):
        w1, q1 = stedc(torch.tensor(dk), torch.tensor(ek), leaf=64)
        assert np.abs(w[k].numpy() - w1.numpy()).max() < 1e-13 * np.abs(w1.numpy()).max()
        assert compare_vectors(q[k].numpy(), q1.numpy()) < 1e-10


def test_stop_rule_sweeps(monkeypatch):
    """Every merge stops at or before the ceiling (_secular_iters, 60 in
    fp64), at a multiple of STOP_EVERY when it stops early; a merge whose
    poles all stay alive stops well before the ceiling, and so does one
    that deflates (a deflated lane counts as done in the stop test: it
    bisects toward a pole that is not there and never meets the bracket
    test, and its root is thrown away); reading the flag after every sweep
    (JAX's test) gives the same roots to 1e-14."""
    ceiling = _secular_iters(torch.float64)
    d, e = _random(512, 11)
    stedc(torch.tensor(d), torch.tensor(e), leaf=64)
    assert stedc.sweeps and all(0 < s <= ceiling for s in stedc.sweeps)
    assert all(s == ceiling or s % stedc_mod.STOP_EVERY == 0 for s in stedc.sweeps)
    assert any(a < n2 for n2, alive, _ in stedc.compact for a in alive), stedc.compact
    assert all(s < ceiling for s in stedc.sweeps), stedc.sweeps
    # one merge of two Laplacian blocks: every pole alive, none bisecting
    n = 128
    d = np.zeros(n)
    e = np.ones(n - 1)
    w4, _ = stedc(torch.tensor(d), torch.tensor(e), leaf=64)
    assert len(stedc.sweeps) == 1 and stedc.sweeps[0] <= ceiling // 2, stedc.sweeps
    monkeypatch.setattr(stedc_mod, "STOP_EVERY", 1)
    w1, _ = stedc(torch.tensor(d), torch.tensor(e), leaf=64)
    assert stedc.sweeps[0] <= ceiling // 2
    assert np.abs(w1.numpy() - w4.numpy()).max() < 1e-14 * np.abs(w1.numpy()).max()


_DTYPES = {"fp32": (torch.float32, np.float32), "fp64": (torch.float64, np.float64)}


@functools.lru_cache(maxsize=None)
def _early_and_ceiling_runs(name):
    """stedc on a random tridiagonal at n = 1024, leaf 64, in the named
    precision: (d, e, (w, q, sweeps, compact) of the stop rule's run, (w, q,
    sweeps) of a run held to the ceiling: STOP_EVERY above it, so the done
    flag is read only before sweep 0)."""
    tdt, ndt = _DTYPES[name]
    d, e = (x.astype(ndt) for x in _random(1024, 5))
    w, q = stedc(torch.tensor(d), torch.tensor(e), leaf=64)
    early = (w.numpy(), q.numpy(), list(stedc.sweeps), list(stedc.compact))
    with mock.patch.object(stedc_mod, "STOP_EVERY", _secular_iters(tdt) + 1):
        w, q = stedc(torch.tensor(d), torch.tensor(e), leaf=64)
        ceiling = (w.numpy(), q.numpy(), list(stedc.sweeps))
    return d, e, early, ceiling


@pytest.mark.parametrize("name", sorted(_DTYPES))
def test_deflated_lanes_stop_the_secular_iteration_early(name):
    """A merge that deflates (alive < n2 at a compact merge) no longer runs
    to the ceiling (35 sweeps in fp32, 60 in fp64): every merge stops by 16
    sweeps, and the roots and vectors are those of the run held to the
    ceiling (eigenvalues 1e-14 relative in fp64, 4 ulp of max|w| in fp32;
    vectors as the batched merges are held, 1e-10 and 1e-5)."""
    tdt, ndt = _DTYPES[name]
    _, _, (w, q, sweeps, compact), (wc, qc, sweeps_c) = _early_and_ceiling_runs(name)
    ceiling = _secular_iters(tdt)
    assert any(a < n2 for n2, alive, _ in compact for a in alive), compact
    assert sweeps_c == [ceiling] * len(sweeps), sweeps_c
    assert sweeps and all(0 < s <= 16 for s in sweeps), sweeps
    scale = np.abs(wc).max()
    tol = 1e-14 * scale if tdt == torch.float64 else 4 * np.spacing(ndt(scale))
    assert np.abs(w - wc).max() <= tol
    assert compare_vectors(q, qc) < (1e-10 if tdt == torch.float64 else 1e-5)


@pytest.mark.parametrize("name", sorted(_DTYPES))
def test_early_stop_and_ceiling_runs_match_jax_and_scipy(name):
    """Both runs of the test above against JAX's stedc (which tests every
    lane's bracket before each sweep) and scipy.linalg.eigh_tridiagonal in
    fp64, at this file's bars: fp64 eigenvalues within 1e-12 n of max|w|,
    vectors within 1e-8 where the spectrum is simple, residual and
    orthogonality at JAX's level; fp32 eigenvalues within 64 eps32 max|w|."""
    tdt, _ = _DTYPES[name]
    d, e, early, ceiling = _early_and_ceiling_runs(name)
    n = d.shape[0]
    jw, jq = (np.asarray(x) for x in jax_stedc(jnp.asarray(d), jnp.asarray(e), leaf=64))
    sw, sq = scipy.linalg.eigh_tridiagonal(d.astype(np.float64), e.astype(np.float64))
    scale = max(np.abs(jw).max(), 1.0)
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    res = lambda w, q: np.abs(t @ q - q * w).max()
    for w, q in (early[:2], ceiling[:2]):
        for rw, rq in ((jw, jq), (sw, sq)):
            if tdt == torch.float32:
                assert np.abs(w - rw).max() < 64 * np.finfo(np.float32).eps * np.abs(rw).max()
                continue
            assert np.abs(w - rw).max() < 1e-12 * scale * n
            if np.diff(rw).min() > 1e-6 * scale:
                assert compare_vectors(q, rq) < 1e-8
        if tdt == torch.float64:
            assert res(w, q) < 4 * res(jw, jq) + 1e-13 * scale * n
            assert np.abs(q.T @ q - np.eye(n)).max() < 1e-11 * n
