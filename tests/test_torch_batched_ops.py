"""The port's one-stage stages with a leading batch axis against ``jax.vmap``
of the JAX package's functions, on the CPU.

Each batch is made with numpy from a seed (a distinct pair an item) and
goes to both packages. The JAX side runs as the JAX package's own batched
tests run it (tests/test_batched.py): ``jax.vmap`` of the unbatched
function. Each batched stage is also held against the port's own
unbatched call on every item. Tolerances: fp64 1e-12 relative (to the
largest entry of the reference); fp32 stages as the unbatched
tests/test_torch_pipeline.py and test_torch_real_ops.py hold them.
"""

import functools

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from eigensolver_gpu_tpu.ops import refine as jax_refine
from eigensolver_gpu_tpu.ops.sytrd import sytrd as jax_sytrd
from eigensolver_gpu_tpu.ops.planar import pcholesky_lower as jax_pchol
from eigensolver_gpu_tpu.ops.refine_planar import refine_gevp_planar as jax_refine_planar
from eigensolver_gpu_tpu.ops.stedc import stedc as jax_stedc
from eigensolver_gpu_tpu.ops.sytrd_planar import hetrd_planar as jax_hetrd
from eigensolver_gpu_tpu.ops.unmtr_planar import unmtr_planar as jax_unmtr
from eigensolver_gpu_torch.ops import refine, sytrd, unmtr
from eigensolver_gpu_torch.ops.pchol import pchol_block_plain, pchol_block_planar
from eigensolver_gpu_torch.ops.planar import pcholesky_lower
from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
from eigensolver_gpu_torch.ops.stedc import stedc
from eigensolver_gpu_torch.ops.sytrd_planar import hetrd_planar
from eigensolver_gpu_torch.ops.unmtr_planar import unmtr_planar
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    random_hpd_pair,
    random_spd_pair,
)

torch.set_num_threads(2)

BATCH = 3
T = lambda x, dt=torch.float64: torch.tensor(np.ascontiguousarray(x), dtype=dt)
N = lambda x: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    want = N(want)
    return np.abs(N(got) - want).max() / max(np.abs(want).max(), 1e-300)


def _hpd_batch(n, seed, which=0):
    """(BATCH, n, n) complex: item k is random_hpd_pair(n, seed + k)[which]."""
    return np.stack([random_hpd_pair(n, seed=seed + k)[which] for k in range(BATCH)])


def _spd_batch(n, seed, which=0):
    return np.stack([random_spd_pair(n, seed=seed + k)[which] for k in range(BATCH)])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_pcholesky_lower_batched_matches_vmap(dt):
    """L and info of a batch of 3 at n = 64 (two 32-blocks: K1's plain
    version in fp32, the substitution route in fp64) against jax.vmap of
    the JAX function and against the port's call on each item. Item 1's
    B has a negative pivot at row 40: its info is 41 on every side and
    the other items are the same as in an all-PD batch."""
    n, nb = 64, 32
    b = _hpd_batch(n, 20, which=1)
    b[1, 40, 40] = -50.0
    br, bi = b.real.astype(dt), b.imag.astype(dt)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    (lr, li), info = pcholesky_lower((T(br, tdt), T(bi, tdt)), nb=nb)
    (jlr, jli), jinfo = jax.vmap(functools.partial(jax_pchol, nb=nb))((br, bi))
    assert info.shape == (BATCH,) and info.dtype == torch.int32
    assert N(info).tolist() == np.asarray(jinfo).tolist() == [0, 41, 0]
    tol = 1e-12 if dt == np.float64 else 1e-5
    for k in (0, 2):  # the non-PD item's factor is undefined past its pivot
        assert _rel(lr[k], jlr[k]) < tol and _rel(li[k], jli[k]) < tol
    for k in range(BATCH):
        (l1r, l1i), info1 = pcholesky_lower((T(br[k], tdt), T(bi[k], tdt)), nb=nb)
        assert int(info1) == int(info[k])
        cols = slice(0, 40 if k == 1 else n)  # item 1: the columns before its pivot
        assert _rel(lr[k][:, cols], l1r[:, cols]) < tol and _rel(li[k][:, cols], l1i[:, cols]) < tol
    pd = b.copy()
    pd[1] = random_hpd_pair(n, seed=21)[1]
    (pr, pi), pinfo = pcholesky_lower((T(pd.real, tdt), T(pd.imag, tdt)), nb=nb)
    assert N(pinfo).tolist() == [0, 0, 0]
    for k in (0, 2):
        assert torch.equal(pr[k], lr[k]) and torch.equal(pi[k], li[k])


def test_pchol_block_plain_batched_equals_per_item_calls():
    """K1's plain version with a batch axis: each item equals the call on
    that item alone, bit for bit, also past a bad pivot (item 2) and at a
    ragged width; the wrapper on CPU tensors takes the plain version and
    counts no launch."""
    rng = np.random.default_rng(5)
    for nb in (33, 64):
        t = rng.standard_normal((BATCH, nb, nb)) + 1j * rng.standard_normal((BATCH, nb, nb))
        a = t @ t.conj().transpose(0, 2, 1) + nb * np.eye(nb)
        a[2, 7, 7] = -1e4
        dr, di = T(a.real, torch.float32), T(a.imag, torch.float32)
        before = pchol_block_planar.launches
        got = pchol_block_planar(dr, di)
        assert pchol_block_planar.launches == before
        assert got[4].shape == (BATCH,) and N(got[4]).tolist() == [0, 0, 8]
        for k in range(BATCH):
            want = pchol_block_plain(dr[k], di[k])
            for g, w in zip(got, want):  # the same bits, NaN past the bad pivot included
                torch.testing.assert_close(g[k], w, rtol=0, atol=0, equal_nan=True)


def test_pchol_block_checks_the_batch_layout():
    """Planes of different batch strides and a second batch axis are
    refused rather than copied."""
    z = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError):
        pchol_block_planar(z, torch.zeros((2, 8, 16))[..., :8])
    with pytest.raises(ValueError):
        pchol_block_planar(torch.zeros((2, 2, 8, 8)), torch.zeros((2, 2, 8, 8)))
    wide = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError):
        pchol_block_planar(z, wide[:, ::2])


def test_hetrd_planar_batched_matches_vmap():
    """d, e and tau of a batch of 3 at n = 64 (fp64, two buckets) against
    jax.vmap of the JAX hetrd and the port's call on each item."""
    n = 64
    a = _hpd_batch(n, 30)
    (pr, pi), d, e, (tr, ti) = hetrd_planar(T(a.real), T(a.imag), nb=16, bucket=32)
    jf = jax.vmap(functools.partial(jax_hetrd, nb=16, bucket=32))
    _, jd, je, (jtr, jti) = jf(a.real, a.imag)
    assert d.shape == (BATCH, n) and e.shape == (BATCH, n - 1) and tr.shape == (BATCH, n - 1)
    for got, want in ((d, jd), (e, je), (tr, jtr), (ti, jti)):
        assert _rel(got, want) < 1e-12
    for k in range(BATCH):
        _, d1, e1, (t1r, t1i) = hetrd_planar(T(a[k].real), T(a[k].imag), nb=16, bucket=32)
        for got, want in ((d[k], d1), (e[k], e1), (tr[k], t1r), (ti[k], t1i)):
            assert _rel(got, want) < 1e-12


def test_hetrd_planar_refuses_a_batch_with_use_pallas():
    """Named for the refusal it replaced: hetrd_planar(use_pallas=True) now
    takes a batch. A batch of 3 at n = 256 in fp32 (bucket 128: the 256
    bucket's four panels through the latrd wrapper, one call a panel for
    the whole batch; the 128 bucket the column loop): d, e and tau of each
    item as the port's unbatched call on it, within rtol 1e-4 / atol 1e-3
    (fp32 sums in another order)."""
    n = 256
    a = _hpd_batch(n, 31)
    ar, ai = T(a.real, torch.float32), T(a.imag, torch.float32)
    calls = []
    import eigensolver_gpu_torch.ops.sytrd_planar as sp

    real = sp.latrd_panel_planar
    sp.latrd_panel_planar = lambda x, *args, **kw: calls.append(tuple(x.shape)) or real(
        x, *args, **kw)
    try:
        _, d, e, (tr, ti) = hetrd_planar(ar, ai, nb=32, bucket=128, use_pallas=True)
    finally:
        sp.latrd_panel_planar = real
    assert calls == [(BATCH, n, n)] * 4
    assert d.shape == (BATCH, n) and e.shape == tr.shape == ti.shape == (BATCH, n - 1)
    for k in range(BATCH):
        _, d1, e1, (t1r, t1i) = hetrd_planar(ar[k], ai[k], nb=32, bucket=128, use_pallas=True)
        for got, want in ((d[k], d1), (e[k], e1), (tr[k], t1r), (ti[k], t1i)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_stedc_batched_matches_vmap(dt):
    """A batch of 3 tridiagonals at n = 100 (leaf 16: 7 leaves, a ragged
    merge tree), item 1 scaled by 1e3 (the scaling is per problem): w
    within 1e-12 relative (fp64) / 64 eps32 ||T|| (fp32) of jax.vmap of
    the JAX stedc and of scipy, q by compare_vectors, and each item as the
    port's call on it alone."""
    n = 100
    rng = np.random.default_rng(40)
    d = rng.standard_normal((BATCH, n))
    e = rng.standard_normal((BATCH, n - 1))
    d[1] *= 1e3
    e[1] *= 1e3
    d, e = d.astype(dt), e.astype(dt)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    w, q = stedc(T(d, tdt), T(e, tdt), leaf=16)
    jw, jq = jax.vmap(functools.partial(jax_stedc, leaf=16))(d, e)
    assert w.shape == (BATCH, n) and q.shape == (BATCH, n, n)
    for k in range(BATCH):
        w_ref = scipy.linalg.eigh_tridiagonal(d[k].astype(np.float64), e[k].astype(np.float64),
                                              eigvals_only=True)
        tol = 1e-12 if dt == np.float64 else 64 * np.finfo(np.float32).eps
        assert _rel(w[k], w_ref) < tol and _rel(w[k], jw[k]) < tol
        assert compare_vectors(q[k].numpy(), np.asarray(jq[k])) < (1e-8 if dt == np.float64
                                                                     else 1e-2)
        w1, q1 = stedc(T(d[k], tdt), T(e[k], tdt), leaf=16)
        assert _rel(w[k], w1) < tol
        assert compare_vectors(q[k].numpy(), q1.numpy()) < (1e-10 if dt == np.float64 else 1e-4)


def test_unmtr_planar_batched_matches_vmap():
    """Q C for a batch of 3 at n = 64 from the batched hetrd: against
    jax.vmap of the JAX unmtr on the same reflectors, and the port's call
    on each item (1e-12 relative)."""
    n = 64
    a = _hpd_batch(n, 50)
    (pr, pi), _, _, (tr, ti) = hetrd_planar(T(a.real), T(a.imag), nb=16, bucket=64)
    rng = np.random.default_rng(51)
    cr, ci = rng.standard_normal((BATCH, n, 8)), rng.standard_normal((BATCH, n, 8))
    zr, zi = unmtr_planar(pr, pi, tr, ti, T(cr), T(ci), nb=16)
    jf = jax.vmap(functools.partial(jax_unmtr, nb=16))
    jzr, jzi = jf(N(pr), N(pi), N(tr), N(ti), cr, ci)
    assert _rel(zr, jzr) < 1e-12 and _rel(zi, jzi) < 1e-12
    for k in range(BATCH):
        z1r, z1i = unmtr_planar(pr[k], pi[k], tr[k], ti[k], T(cr[k]), T(ci[k]), nb=16)
        assert _rel(zr[k], z1r) < 1e-12 and _rel(zi[k], z1i) < 1e-12


def _perturbed_bases(pairs, seed, exact=()):
    """The exact generalized eigenbasis of each pair, rounded to fp32 and
    perturbed at the 1e-5 level (what an fp32 pipeline hands to the
    refinement), with w; items in ``exact`` get the fp64 basis itself."""
    rng = np.random.default_rng(seed)
    zs, ws = [], []
    for k, (a, b) in enumerate(pairs):
        w, z = scipy.linalg.eigh(a, b)
        if k not in exact:
            z = (z + 1e-5 * rng.standard_normal(z.shape)).astype(
                np.complex64 if np.iscomplexobj(z) else np.float32).astype(z.dtype)
            w = w + 1e-5 * rng.standard_normal(w.shape)
        zs.append(z)
        ws.append(w)
    return np.stack(zs), np.stack(ws)


def test_refine_gevp_planar_batched_matches_vmap():
    """A batch of 3 at n = 48, block (8, 16), two sweeps (one coarse fp32,
    one fp64) and escalation allowed: w within 1e-12 relative of jax.vmap
    of the JAX refinement (its fp64 'emulated' products) and of the port's
    call on each item; vectors phase-insensitively within 1e-9."""
    n, sel = 48, (8, 16)
    pairs = [random_hpd_pair(n, seed=60 + k) for k in range(BATCH)]
    z, w0 = _perturbed_bases(pairs, 61)
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    kw = dict(sweeps=2, sel=sel, extra_max=2)
    w, (xr, xi) = refine_gevp_planar((T(a.real), T(a.imag)), (T(b.real), T(b.imag)),
                                     (T(z.real), T(z.imag)), w0=T(w0), **kw)
    jf = jax.vmap(lambda a, b, x, w0: jax_refine_planar(a, b, x, w0=w0, gemm="emulated", **kw))
    jw, (jxr, jxi) = jf((a.real, a.imag), (b.real, b.imag), (z.real, z.imag), w0)
    assert w.shape == (BATCH, sel[1]) and xr.shape == (BATCH, n, sel[1])
    x = xr.numpy() + 1j * xi.numpy()
    jx = np.asarray(jxr) + 1j * np.asarray(jxi)
    assert _rel(w, jw) < 1e-12
    for k in range(BATCH):
        assert compare_vectors(x[k], jx[k]) < 1e-9
        w1, (x1r, x1i) = refine_gevp_planar(
            (T(a[k].real), T(a[k].imag)), (T(b[k].real), T(b[k].imag)),
            (T(z[k].real), T(z[k].imag)), w0=T(w0[k]), **kw)
        assert _rel(w[k], w1) < 1e-12
        assert compare_vectors(x[k], x1r.numpy() + 1j * x1i.numpy()) < 1e-10


@pytest.mark.parametrize("cplx", [False, True])
def test_sytrd_and_unmtr_batched_match_vmap(cplx):
    """The real/complex sytrd and unmtr with a batch of 3 at n = 64
    (fp64): d, e, tau within 1e-12 relative of jax.vmap of the JAX sytrd
    and of the port's call on each item; Q rebuilds each A."""
    n = 64
    a = (_hpd_batch if cplx else _spd_batch)(n, 70)
    packed, d, e, tau = sytrd.sytrd(T(a, None), nb=16, bucket=32)
    jf = jax.vmap(functools.partial(jax_sytrd, nb=16, bucket=32))
    _, jd, je, jtau = jf(jnp.asarray(a))
    for got, want in ((d, jd), (e, je), (tau, jtau)):
        assert _rel(got, want) < 1e-12
    eye = torch.eye(n, dtype=packed.dtype).expand(BATCH, n, n).clone()
    q = unmtr.unmtr(packed, tau, eye, nb=16)
    for k in range(BATCH):
        p1, d1, e1, t1 = sytrd.sytrd(T(a[k], None), nb=16, bucket=32)
        for got, want in ((d[k], d1), (e[k], e1), (tau[k], t1)):
            assert _rel(got, want) < 1e-12
        q1 = unmtr.unmtr(p1, t1, torch.eye(n, dtype=p1.dtype), nb=16)
        assert _rel(q[k], q1) < 1e-12
        tri = np.diag(N(d[k])) + np.diag(N(e[k]), 1) + np.diag(N(e[k]), -1)
        qk = N(q[k])
        assert np.abs(qk @ tri @ qk.conj().T - a[k]).max() < 1e-11 * n


@pytest.mark.parametrize("cplx", [False, True])
def test_refine_gevp_batched_matches_vmap(cplx):
    """The real/complex refinement with a batch of 3 at n = 48, block
    (8, 16), three sweeps and escalation allowed: w within 1e-12 relative
    of jax.vmap of the JAX refinement and of the port's call on each
    item; vectors phase-insensitively within 1e-9."""
    n, sel = 48, (8, 16)
    pairs = [(random_hpd_pair if cplx else random_spd_pair)(n, seed=80 + k)
             for k in range(BATCH)]
    z, w0 = _perturbed_bases(pairs, 81)
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    kw = dict(sweeps=3, sel=sel, extra_max=2)
    w, x = refine.refine_gevp(T(a, None), T(b, None), T(z, None), w0=T(w0), **kw)
    jf = jax.vmap(lambda a, b, x, w0: jax_refine.refine_gevp(a, b, x, w0=w0, gemm="emulated",
                                                             **kw))
    jw, jx = jf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(z), jnp.asarray(w0))
    assert w.shape == (BATCH, sel[1]) and x.shape == (BATCH, n, sel[1])
    assert _rel(w, jw) < 1e-12
    for k in range(BATCH):
        assert compare_vectors(N(x[k]), np.asarray(jx[k])) < 1e-9
        w1, x1 = refine.refine_gevp(T(a[k], None), T(b[k], None), T(z[k], None),
                                    w0=T(w0[k]), **kw)
        assert _rel(w[k], w1) < 1e-12
        assert compare_vectors(N(x[k]), N(x1)) < 1e-10


def _count_sweeps(monkeypatch, module):
    calls = []
    real = module._sweep

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "_sweep", counted)
    return calls


@pytest.mark.parametrize("planar", [False, True])
def test_escalation_is_per_item(monkeypatch, planar):
    """Item 0 starts from the exact basis (its defect after one fp64 sweep
    is below the tolerance: no extra sweep), item 1 from a perturbed fp32
    basis (it escalates). The batch sweeps while item 1 does, item 0 keeps
    its state, and each item equals its unbatched solve (1e-13 relative);
    jax.vmap of the JAX function (a while_loop under vmap) agrees."""
    from eigensolver_gpu_torch.ops import refine_planar

    module = refine_planar if planar else refine
    n, sel = 48, (8, 16)
    pairs = [(random_hpd_pair if planar else random_spd_pair)(n, seed=90 + k) for k in range(2)]
    z, w0 = _perturbed_bases(pairs, 91, exact=(0,))
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    kw = dict(sweeps=1, coarse_first=False, sel=sel, extra_max=2)

    def solve(a, b, z, w0):
        if planar:
            w, (xr, xi) = refine_gevp_planar((T(a.real), T(a.imag)), (T(b.real), T(b.imag)),
                                             (T(z.real), T(z.imag)), w0=T(w0), **kw)
            return w, xr.numpy() + 1j * xi.numpy()
        w, x = refine.refine_gevp(T(a), T(b), T(z), w0=T(w0), **kw)
        return w, N(x)

    calls = _count_sweeps(monkeypatch, module)
    singles = []
    for k in range(2):
        calls.clear()
        singles.append(solve(a[k], b[k], z[k], w0[k]))
        singles[-1] += (len(calls),)
    assert singles[0][2] == 1 and singles[1][2] > 1  # item 1 alone escalates
    calls.clear()
    w, x = solve(a, b, z, w0)
    assert len(calls) == singles[1][2]
    for k in range(2):
        assert _rel(w[k], singles[k][0]) < 1e-13
        assert np.abs(x[k] - singles[k][1]).max() < 1e-13 * np.abs(singles[k][1]).max()
    jfn = jax_refine_planar if planar else jax_refine.refine_gevp
    if planar:
        jw, _ = jax.vmap(lambda a, b, x, w0: jfn(a, b, x, w0=w0, gemm="emulated", **kw))(
            (a.real, a.imag), (b.real, b.imag), (z.real, z.imag), w0)
    else:
        jw, _ = jax.vmap(lambda a, b, x, w0: jfn(a, b, x, w0=w0, gemm="emulated", **kw))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(z), jnp.asarray(w0))
    assert _rel(w, jw) < 1e-12


def test_convert_carries_batches():
    """planar_from_numpy and dense_from_numpy take (batch, n, n) arrays:
    contiguous tensors of the same values, on the device asked for."""
    from eigensolver_gpu_torch.utils.convert import dense_from_numpy, planar_from_numpy

    a, b = _hpd_batch(8, 1), _hpd_batch(8, 1, which=1)
    planes = planar_from_numpy(a, b, device="cpu")
    for got, want in zip(planes, (a.real, a.imag, b.real, b.imag)):
        assert got.shape == (BATCH, 8, 8) and got.is_contiguous() and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)
    ta, tb = dense_from_numpy(a, b, device="cpu")
    assert ta.dtype == torch.complex128 and np.array_equal(ta.numpy(), a)
    assert np.array_equal(tb.numpy(), b) and tb.shape == (BATCH, 8, 8)
