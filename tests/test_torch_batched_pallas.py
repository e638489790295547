"""The ``use_pallas=True`` route on a batch (eigensolver_gpu_torch) against
``jax.vmap`` of the JAX package's functions, on the CPU.

Under ``jax.vmap`` every JAX ``pallas_call`` gets a batch axis, so the
latrd panel (K2), the planar hemv (K3) and the symv (K4) each serve a
whole batch; the port's wrappers take the same leading batch axis (one
launch a call on the card; here their plain versions). The same numpy
inputs, made from a seed, go through ``jax.vmap`` of the JAX function (its
Pallas kernels in interpret mode) and through the port: the kernels' own
functions, ``hetrd_planar`` and ``sytrd`` with ``use_pallas=True``, and the
batched drivers, which now run such a batch as one batched solve. Each
batched item is also held to the port's unbatched call on it. The card's
side (one launch a call, every item bit-identical to its unbatched launch)
is in tests/test_torch_card.py.
"""

import functools

import jax
import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_batched as jax_planar_batched
from eigensolver_gpu_tpu.ops.hemv_pallas import hemv_planar_auto
from eigensolver_gpu_tpu.ops.latrd_pallas import latrd_panel_planar as jax_latrd
from eigensolver_gpu_tpu.ops.symv_pallas import symv_auto
from eigensolver_gpu_tpu.ops.sytrd import sytrd as jax_sytrd
from eigensolver_gpu_tpu.ops.sytrd_planar import hetrd_planar as jax_hetrd
from eigensolver_gpu_tpu.parallel.sharded import sygvdx_batched as jax_real_batched
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.ops import sytrd as sytrd_mod
from eigensolver_gpu_torch.ops import sytrd_planar
from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
from eigensolver_gpu_torch.ops.symv import hemv_planar, symv
from eigensolver_gpu_torch.ops.sytrd import sytrd
from eigensolver_gpu_torch.ops.sytrd_planar import hetrd_planar
from eigensolver_gpu_torch.parallel import sygvdx_batched
from test_torch_batched_helpers import (
    MIXED,
    as_complex,
    check_against_single,
    check_items,
    pair_batch,
    planes,
)

torch.set_num_threads(2)

T = lambda x, dt=torch.float32: torch.tensor(np.ascontiguousarray(x), dtype=dt)
# fp32 on O(15) data with rank-2 accumulation in another summation order
# (tests/test_torch_kernels.py's latrd tolerance, tests/test_torch_pipeline.py's
# hetrd tolerance)
RTOL, ATOL = 1e-4, 1e-3
N_PLANAR, N_REAL, IU = 256, 512, 16  # K2 takes the 256 bucket, K4 the 512 one


def _hermitian_batch(batch, n, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    a = (t + t.conj().transpose(0, 2, 1)) / 2
    return a.real.astype(np.float32), a.imag.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("pe", [256, 224, 32])
def test_latrd_panel_batched_matches_vmap(pe):
    """3 x mb = 256: the seven outputs, with a leading batch axis, against
    jax.vmap of the Pallas panel (interpret mode); each item within 1e-4
    relative of the port's unbatched call on it (on the CPU the plain
    version's batched products and the unbatched matrix-vector products sum
    in other orders: 1.1e-5 apart at most after the panel's 32 dependent
    columns here; on the card the kernel gives the same bits,
    tests/test_torch_card.py)."""
    batch, mb, nb = 3, 256, 32
    ar, ai = _hermitian_batch(batch, mb, 150)
    want = jax.vmap(functools.partial(jax_latrd, panel_end=pe, nb=nb, tile=64,
                                      interpret=True))(ar, ai)
    got = latrd_panel_planar(T(ar), T(ai), pe, nb=nb)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.shape[0] == batch
        _close(g.numpy(), w)
    for k in range(batch):
        one = latrd_panel_planar(T(ar[k]), T(ai[k]), pe, nb=nb)
        for g, w in zip(got, one):
            assert _rel(g[k].numpy(), w.numpy()) < 1e-4


@pytest.mark.parametrize("kernel", ["symv", "hemv_planar"])
def test_mv_kernels_batched_match_vmap(kernel):
    """3 x n = 512 in fp32 against jax.vmap of symv_auto / hemv_planar_auto
    (the Pallas kernels in interpret mode): 1e-5 relative (sums of length n
    in another order)."""
    batch, n = 3, 512
    ar, ai = _hermitian_batch(batch, n, 151)
    rng = np.random.default_rng(152)
    vr, vi = (rng.standard_normal((batch, n)).astype(np.float32) for _ in range(2))
    if kernel == "symv":
        want = [jax.vmap(symv_auto)(ar, vr)]
        got = [symv(T(ar), T(vr))]
    else:
        want = jax.vmap(hemv_planar_auto)(ar, ai, vr, vi)
        got = hemv_planar(T(ar), T(ai), T(vr), T(vi))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (batch, n)
        assert _rel(g.numpy(), w) < 1e-5


@pytest.mark.parametrize("kernel", ["symv", "hemv_planar"])
def test_mv_kernels_batched_extent_equals_the_unbatched_calls(kernel):
    """extent = 300 on 3 x (512, 512) views of (3, 600, 600) matrices (the
    tridiagonalization's bucket layout): every item as the port's unbatched
    call on it, and as the dense product, to fp32 rounding."""
    batch, n, c = 3, 512, 300
    br, bi = _hermitian_batch(batch, 600, 153)
    mr, mi = T(br)[:, :n, :n], T(bi)[:, :n, :n]
    rng = np.random.default_rng(154)
    vr, vi = (T(rng.standard_normal((batch, n))) for _ in range(2))
    if kernel == "symv":
        got = [symv(mr, vr, extent=c)]
        one = lambda k: [symv(mr[k], vr[k], extent=c)]
        dense = lambda k: [mr[k, :c, :c] @ vr[k, :c]]
    else:
        got = hemv_planar(mr, mi, vr, vi, extent=c)
        one = lambda k: hemv_planar(mr[k], mi[k], vr[k], vi[k], extent=c)
        dense = lambda k: [mr[k, :c, :c] @ vr[k, :c] - mi[k, :c, :c] @ vi[k, :c],
                           mr[k, :c, :c] @ vi[k, :c] + mi[k, :c, :c] @ vr[k, :c]]
    for k in range(batch):
        for g, w, d in zip(got, one(k), dense(k)):
            assert tuple(g.shape) == (batch, c)
            assert _rel(g[k].numpy(), w.numpy()) < 1e-6
            assert _rel(g[k].numpy(), d.numpy()) < 1e-5


def test_hetrd_planar_use_pallas_batched_matches_vmap():
    """2 x n = 512, bucket = 128: the 256 and 512 buckets take the latrd
    panel (one call a panel for the batch), 128 and 384 the column loop.
    d, e and tau against jax.vmap of the JAX hetrd with use_pallas=True,
    and each item against the port's unbatched call, within rtol 1e-4 /
    atol 1e-3."""
    n = 512
    a, _ = pair_batch(2, n, seed=155)
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    jf = jax.vmap(functools.partial(jax_hetrd, nb=32, bucket=128, use_pallas=True))
    _, jd, je, (jtr, jti) = jf(ar, ai)
    _, d, e, (tr, ti) = hetrd_planar(T(ar), T(ai), nb=32, bucket=128, use_pallas=True)
    assert d.shape == (2, n) and e.shape == tr.shape == ti.shape == (2, n - 1)
    for got, want in ((d, jd), (e, je), (tr, jtr), (ti, jti)):
        _close(got.numpy(), want)
    for k in range(2):
        _, d1, e1, (tr1, ti1) = hetrd_planar(T(ar[k]), T(ai[k]), nb=32, bucket=128,
                                             use_pallas=True)
        for got, want in ((d[k], d1), (e[k], e1), (tr[k], tr1), (ti[k], ti1)):
            _close(got.numpy(), want.numpy())


def _real_reduction_close(got, want, nb=32):
    """Two fp32 real reductions (d, e, tau) of one matrix, as
    tests/test_torch_real_ops.py holds them: the map A -> (d, e,
    reflectors) is ill-conditioned (a pivot near zero flips a reflector's
    sign and the entries drift apart towards the columns reduced last), so
    the first panel (the last nb - 1 entries) within rtol 1e-4 / atol 1e-3,
    and d and |e| as a whole within 5e-2."""
    for g, w in zip(got, want):
        _close(np.asarray(g)[-(nb - 1):], np.asarray(w)[-(nb - 1):])
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=0, atol=5e-2)
    np.testing.assert_allclose(np.abs(np.asarray(got[1])), np.abs(np.asarray(want[1])), rtol=0,
                               atol=5e-2)


def test_sytrd_use_pallas_batched_matches_vmap():
    """2 x n = 512 real fp32, bucket = 256: the 512 bucket's A v through
    symv (one call a column for the batch), the 256 bucket the gemv; d, e
    and tau against jax.vmap of the JAX sytrd with use_pallas=True and each
    item against the port's unbatched call (_real_reduction_close); each
    item's tridiagonal keeps its matrix's spectrum to 1e-4 ||A||."""
    n = 512
    a, _ = pair_batch(2, n, seed=156, cplx=False)
    a = a.astype(np.float32)
    jf = jax.vmap(functools.partial(jax_sytrd, nb=32, bucket=256, use_pallas=True))
    _, jd, je, jtau = jf(a)
    _, d, e, tau = sytrd(T(a), nb=32, bucket=256, use_pallas=True)
    assert d.shape == (2, n) and e.shape == tau.shape == (2, n - 1)
    for k in range(2):
        got = (d[k].numpy(), e[k].numpy(), tau[k].numpy())
        _real_reduction_close(got, (jd[k], je[k], jtau[k]))
        _, d1, e1, tau1 = sytrd(T(a[k]), nb=32, bucket=256, use_pallas=True)
        _real_reduction_close(got, (d1.numpy(), e1.numpy(), tau1.numpy()))
        w = scipy.linalg.eigh_tridiagonal(got[0].astype(np.float64), got[1].astype(np.float64),
                                          eigvals_only=True)
        w_ref = np.linalg.eigvalsh(a[k].astype(np.float64))
        assert np.abs(w - w_ref).max() < 1e-4 * np.abs(w_ref).max()


def _logged(monkeypatch, mod, name):
    """Wrap mod.name to log the leading axes of its first argument."""
    fn, log = getattr(mod, name), []
    monkeypatch.setattr(mod, name, lambda *args, **k: log.append(tuple(args[0].shape[:-2]))
                        or fn(*args, **k))
    return log


def test_zhegvdx_planar_batched_use_pallas_matches_jax(monkeypatch):
    """2 x random_hpd_pair(256), iu = 16, mp with use_pallas=True: one
    batched solve (the mixed driver and its fp32 inner solve, each once on
    the whole batch; no per-item call), the K2 wrapper called on the batch
    (the 256 bucket's four panels), eigenvalues within 1e-10 n of JAX's
    batched driver and of scipy, ge_residual < 1e-12, info exact. JAX's
    batched driver runs in fp64, as in tests/test_torch_batched_planar.py:
    compiling jax.vmap of its mixed driver took 115 s here on a cold cache,
    and the bars are fp64's; JAX's Pallas panel under jax.vmap is held by
    the latrd and hetrd tests above."""
    import eigensolver_gpu_torch.models.zhegvdx_planar as zp

    a, b = pair_batch(2, N_PLANAR, seed=157)
    cfg = dict(MIXED, use_pallas=True)
    jw, _, _, jinfo = jax_planar_batched(a.real, a.imag, b.real, b.imag, il=1, iu=IU,
                                         cfg=JaxConfig(use_pallas=True))
    calls = _logged(monkeypatch, zp, "zhegvdx_planar")
    k2 = _logged(monkeypatch, sytrd_planar, "latrd_panel_planar")
    res = eig.zhegvdx_planar_batched(*planes(a, b), il=1, iu=IU, cfg=eig.SolverConfig(**cfg))
    monkeypatch.undo()
    assert calls == [(2,), (2,)]
    assert k2 == [(2,)] * 4
    check_items(a, b, res.w.numpy(), as_complex(res.zr, res.zi), res.info.numpy(), IU,
                jw=np.asarray(jw), jinfo=np.asarray(jinfo))


def test_sygvdx_batched_use_pallas_matches_jax(monkeypatch):
    """2 x random_spd_pair(512), iu = 16, mp with use_pallas=True: one
    batched solve (the mixed body and its fp32 inner solve, each once on the
    whole batch; no per-item call), the K4 wrapper called on the batch
    once a column of the 512 bucket (8 panels of 32), eigenvalues within
    1e-10 n of JAX's sygvdx_batched and of scipy, ge_residual < 1e-12, info
    exact."""
    import eigensolver_gpu_torch.models.sygvdx as sg
    import eigensolver_gpu_torch.parallel.sharded as sharded

    a, b = pair_batch(2, N_REAL, seed=158, cplx=False)
    cfg = dict(MIXED, use_pallas=True)
    jw, _, jinfo = jax_real_batched(a, b, il=1, iu=IU, cfg=JaxConfig(**cfg))
    outer = _logged(monkeypatch, sharded, "_sygvdx")
    inner = _logged(monkeypatch, sg, "_sygvdx")
    k4 = _logged(monkeypatch, sytrd_mod, "symv")
    res = sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU,
                         cfg=eig.SolverConfig(**cfg))
    monkeypatch.undo()
    assert outer == inner == [(2,)]
    assert k4 == [(2,)] * 256
    check_items(a, b, res.w.numpy(), res.z.numpy(), res.info.numpy(), IU,
                jw=np.asarray(jw), jinfo=np.asarray(jinfo))


@pytest.mark.parametrize("driver", ["planar", "real"])
def test_non_pd_item_in_a_use_pallas_batch_sets_its_own_info(driver):
    """A batch of 3 (mp, use_pallas=True, the kernels' buckets reached)
    whose item 1 has a negative pivot at row 10: info 10 there, as the
    unbatched solve of it gives, no exception; items 0 and 2 as in the
    same batch with every B positive definite (check_against_single)."""
    cplx = driver == "planar"
    n = N_PLANAR if cplx else N_REAL
    a, b = pair_batch(3, n, seed=159, cplx=cplx)
    bad = b.copy()
    bad[1, 9, 9] = -50.0
    cfg = eig.SolverConfig(**MIXED, use_pallas=True)
    if cplx:
        solve = lambda b_: eig.zhegvdx_planar_batched(*planes(a, b_), il=1, iu=IU, cfg=cfg)
        vecs = lambda r: as_complex(r.zr, r.zi)
        one = eig.zhegvdx_planar(*(x[1] for x in planes(a, bad)), il=1, iu=IU, cfg=cfg)
    else:
        solve = lambda b_: sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b_), il=1,
                                          iu=IU, cfg=cfg)
        vecs = lambda r: r.z.numpy()
        one = eig.sygvdx(torch.from_numpy(a[1]), torch.from_numpy(bad[1]), il=1, iu=IU,
                         cfg=cfg)
    res, good = solve(bad), solve(b)
    assert res.info.tolist() == [0, 10, 0] and int(one.info) == 10
    for k in (0, 2):
        check_against_single(res.w[k].numpy(), vecs(res)[k], (good.w[k].numpy(),
                                                              vecs(good)[k]), n)
