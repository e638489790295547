"""The port's ozaki digit products (eigensolver_gpu_torch/ops/ozaki.py) and
the refinement's ``gemm='ozaki'`` routes against the JAX package, on the CPU.

The digit slicing is exact, so the slicings, the products and their
planar and chunked forms are held BIT for bit against JAX on the JAX
package's own accuracy cases (tests/test_ozaki.py). The refinements are
held against the JAX functions' defaults (``gemm='ozaki'``): eigenvalues
within 1e-13 relative, vectors phase-insensitively (their coarse fp32
sweeps round differently in the two packages).
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from eigensolver_gpu_tpu.ops import ozaki as jax_ozaki
from eigensolver_gpu_tpu.ops.refine import refine_eigh as jax_refine_eigh
from eigensolver_gpu_tpu.ops.refine import refine_gevp as jax_refine_gevp
from eigensolver_gpu_tpu.ops.refine_planar import refine_gevp_planar as jax_refine_planar
from eigensolver_gpu_torch.ops import ozaki, refine, refine_planar
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    random_hpd_pair,
    random_spd_pair,
)

torch.set_num_threads(2)

T = lambda x: torch.tensor(np.ascontiguousarray(x))
N = lambda x: np.asarray(x)


def _accuracy_case(name):
    """The operands of the JAX package's ozaki accuracy tests."""
    if name.startswith("random"):
        n, k, m = {"random64": (64, 64, 64), "random257": (257, 129, 65),
                   "random4096": (128, 4096, 96)}[name]
        rng = np.random.default_rng(0)
        return rng.standard_normal((n, k)), rng.standard_normal((k, m))
    if name == "ill_scaled":
        rng = np.random.default_rng(1)
        n = 96
        a = rng.standard_normal((n, n)) * np.exp2(rng.integers(-20, 20, (n, 1)))
        b = rng.standard_normal((n, n)) * np.exp2(rng.integers(-20, 20, (1, n)))
        return a, b
    if name == "extreme":
        rng = np.random.default_rng(4)
        n = 64
        a = rng.standard_normal((n, n)) * np.exp2(rng.integers(-450, 450, (n, 1)).astype(float))
        b = rng.standard_normal((n, n)) * np.exp2(rng.integers(-450, 450, (1, n)).astype(float))
        return a, b
    rng = np.random.default_rng(2)  # zero rows and exact powers of two
    n = 64
    a = rng.standard_normal((n, n))
    a[3] = 0.0
    a[7] = 2.0 ** np.arange(n) % 17
    b = rng.standard_normal((n, n))
    b[:, 5] = 0.0
    return a, b


CASES = ["random64", "random257", "random4096", "ill_scaled", "extreme", "zero_rows"]


def _same(got, want):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32) if want.dtype == jnp.bfloat16 else want)
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype))


def test_digit_policy_matches_jax():
    """digit_bits_for over k = 1 .. 2^20 and nslice_for over every width
    and the bit counts the refinement uses."""
    for k in range(1, 2**20 + 1):
        assert ozaki.digit_bits_for(k) == jax_ozaki.digit_bits_for(k)
    for dbits in range(2, 8):
        for bits in (24, 28, 48, 53):
            assert ozaki.nslice_for(dbits, bits) == jax_ozaki.nslice_for(dbits, bits)


@pytest.mark.parametrize("case", CASES)
def test_slices_match_jax_bit_for_bit(case):
    """ozaki_slice's digits and exponents, by rows and by columns."""
    a, b = _accuracy_case(case)
    dbits = ozaki.digit_bits_for(a.shape[1])
    ns = ozaki.nslice_for(dbits)
    for x, axis in ((a, 0), (b, 1)):
        d, e = ozaki.ozaki_slice(T(x), axis, dbits, ns)
        jd, je = jax_ozaki.ozaki_slice(jnp.asarray(x), axis, dbits, ns)
        assert d.dtype == torch.bfloat16 and e.dtype == torch.int32
        _same(d, jd)
        _same(e, je)


@pytest.mark.parametrize("case", CASES)
def test_matmul_forms_match_jax_bit_for_bit(case):
    """ozaki_matmul, its _pre form from separate slicings (and negated),
    and the chunked form: each equal to JAX's bits; the chunked product
    equals the unchunked one. Accuracy as the JAX test: 1e-13 relative to
    rowmax * colmax * k."""
    a, b = _accuracy_case(case)
    got = ozaki.ozaki_matmul(T(a), T(b))
    _same(got, jax_ozaki.ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
    dbits = ozaki.digit_bits_for(a.shape[1])
    ns = ozaki.nslice_for(dbits)
    pa, pb = ozaki.ozaki_slice(T(a), 0, dbits, ns), ozaki.ozaki_slice(T(b), 1, dbits, ns)
    jpa = jax_ozaki.ozaki_slice(jnp.asarray(a), 0, dbits, ns)
    jpb = jax_ozaki.ozaki_slice(jnp.asarray(b), 1, dbits, ns)
    _same(ozaki.ozaki_matmul_pre(pa, pb, dbits, negate=True),
          jax_ozaki.ozaki_matmul_pre(jpa, jpb, dbits, negate=True))
    chunk = b.shape[1] // 2 if b.shape[1] % 2 == 0 else None
    ch = ozaki.ozaki_matmul_chunked(T(a), T(b), chunk=chunk)
    _same(ch, jax_ozaki.ozaki_matmul_chunked(jnp.asarray(a), jnp.asarray(b), chunk=chunk))
    assert torch.equal(ch, got)
    ra = np.abs(a).max(axis=1, keepdims=True)
    cb = np.abs(b).max(axis=0, keepdims=True)
    assert np.all(np.isfinite(got.numpy()))
    assert np.max(np.abs(got.numpy() - a @ b) / (ra * cb * a.shape[1] + 1e-300)) < 1e-13


@pytest.mark.parametrize("bits", [48, 28])
def test_planar_forms_match_jax_bit_for_bit(bits):
    """ozaki_pmatmul, ozaki_pmatmul_chunked and ozaki_pmatmul_pre (plain,
    transposed lhs, conjugated transposed lhs) from ozaki_planar_slices,
    at the full and the correction's bit count."""
    rng = np.random.default_rng(3)
    n = 96
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    pa, pb = (T(a.real), T(a.imag)), (T(b.real), T(b.imag))
    ja, jb = (jnp.asarray(a.real), jnp.asarray(a.imag)), (jnp.asarray(b.real), jnp.asarray(b.imag))
    for got, want in zip(ozaki.ozaki_pmatmul(pa, pb, bits=bits),
                         jax_ozaki.ozaki_pmatmul(ja, jb, bits=bits)):
        _same(got, want)
    for got, want in zip(ozaki.ozaki_pmatmul_chunked(pa, pb, chunk=32, bits=bits),
                         jax_ozaki.ozaki_pmatmul_chunked(ja, jb, chunk=32, bits=bits)):
        _same(got, want)
    dbits = ozaki.digit_bits_for(n)
    ns = ozaki.nslice_for(dbits, bits)
    rhs = ozaki.ozaki_planar_slices(pb, 1, dbits, ns)
    jrhs = jax_ozaki.ozaki_planar_slices(jb, 1, dbits, ns)
    for axis, tl, conj in ((0, False, False), (1, True, False), (1, True, True)):
        lhs = ozaki.ozaki_planar_slices(pa, axis, dbits, ns, conj=conj)
        jlhs = jax_ozaki.ozaki_planar_slices(ja, axis, dbits, ns, conj=conj)
        got = ozaki.ozaki_pmatmul_pre(lhs, rhs, dbits, transpose_lhs=tl, conj_lhs=conj)
        want = jax_ozaki.ozaki_pmatmul_pre(jlhs, jrhs, dbits, transpose_lhs=tl, conj_lhs=conj)
        for g, w in zip(got, want):
            _same(g, w)
    ref = a @ b
    got = ozaki.ozaki_pmatmul(pa, pb)
    err = np.abs(got[0].numpy() + 1j * got[1].numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-13


def test_batch_axes_give_each_items_bits():
    """A batch of 3 (leading axis) through ozaki_slice, ozaki_matmul, the
    chunked and planar forms: each item bit-identical to its own call."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 40, 56)) * np.exp2(rng.integers(-30, 30, (3, 40, 1)))
    b = rng.standard_normal((3, 56, 24))
    d, e = ozaki.ozaki_slice(T(a), 0, 7, 7)
    got = ozaki.ozaki_matmul(T(a), T(b))
    ch = ozaki.ozaki_matmul_chunked(T(a), T(b), chunk=8)
    pg = ozaki.ozaki_pmatmul((T(a), T(2 * a)), (T(b), T(-b)))
    assert d.shape == (7, 3, 40, 56) and e.shape == (3, 40)
    for k in range(3):
        dk, ek = ozaki.ozaki_slice(T(a[k]), 0, 7, 7)
        assert torch.equal(d[:, k], dk) and torch.equal(e[k], ek)
        one = ozaki.ozaki_matmul(T(a[k]), T(b[k]))
        assert torch.equal(got[k], one) and torch.equal(ch[k], one)
        pk = ozaki.ozaki_pmatmul((T(a[k]), T(2 * a[k])), (T(b[k]), T(-b[k])))
        assert torch.equal(pg[0][k], pk[0]) and torch.equal(pg[1][k], pk[1])


def test_exponents_are_exact_down_to_the_denormals():
    """_floor_log2 and _pow2 over the fp64 range. JAX's values are held
    where they are normal numbers; the JAX CPU backend flushes denormals
    to zero, so below 2^-1022 the port is held to exact arithmetic."""
    x = np.array([1.0, 2.0, 3.0, 0.75, 2.0 ** -1000, 1e-300, 1e300, np.nextafter(2.0, 0.0)])
    assert np.array_equal(ozaki._floor_log2(T(x)).numpy(),
                          N(jax_ozaki._floor_log2(jnp.asarray(x))))
    e = np.arange(-1022, 1024)
    assert np.array_equal(ozaki._pow2(T(e)).numpy(), N(jax_ozaki._pow2(jnp.asarray(e))))
    sub = np.array([5e-324, 2.0 ** -1060, 2.0 ** -1030 * 1.5])
    assert ozaki._floor_log2(T(sub)).tolist() == [-1074, -1060, -1030]
    assert ozaki._pow2(T(np.array([-1074, -1060, -1075, 1024]))).tolist() == [
        5e-324, 2.0 ** -1060, 0.0, float("inf")]


# --- the refinement's gemm='ozaki' routes ------------------------------------


def _perturbed_basis(a, b, seed):
    """The exact generalized eigenbasis rounded to fp32 and perturbed at the
    1e-5 level, with perturbed eigenvalues: what an fp32 pipeline hands to
    the refinement."""
    w, z = scipy.linalg.eigh(a, b)
    rng = np.random.default_rng(seed)
    z32 = (z + 1e-5 * rng.standard_normal(z.shape)).astype(
        np.complex64 if np.iscomplexobj(z) else np.float32)
    return w, z32, (w + 1e-5 * rng.standard_normal(w.shape)).astype(np.float32)


def _rel(got, want):
    got = N(got.numpy() if isinstance(got, torch.Tensor) else got)
    return float(np.abs(got - N(want)).max() / np.abs(N(want)).max())


@pytest.mark.parametrize("chunk", [None, 16])
def test_refine_gevp_planar_ozaki_matches_jax_default(chunk):
    """n = 64, block (8, 24), two sweeps (one coarse fp32, one fp64 in
    ozaki products: the slice-reusing sweep, or with ``chunk`` the chunked
    products) and escalation: against the JAX default (gemm='ozaki');
    eigenvalues within 1e-13 relative, vectors within 1e-9."""
    n, sel = 64, (8, 24)
    a, b = random_hpd_pair(n, seed=64)
    w_ref, z32, w32 = _perturbed_basis(a, b, 65)
    kw = dict(sweeps=2, sel=sel, extra_max=2, chunk=chunk)
    w, (xr, xi) = refine_planar.refine_gevp_planar(
        (T(a.real), T(a.imag)), (T(b.real), T(b.imag)),
        (T(z32.real).double(), T(z32.imag).double()), w0=T(w32).double(), gemm="ozaki", **kw)
    jw, (jxr, jxi) = jax_refine_planar(
        (a.real, a.imag), (b.real, b.imag),
        (z32.real.astype(np.float64), z32.imag.astype(np.float64)), w0=w32.astype(np.float64),
        **kw)
    x = xr.numpy() + 1j * xi.numpy()
    assert _rel(w, jw) < 1e-13
    assert compare_vectors(x, N(jxr) + 1j * N(jxi)) < 1e-9
    assert np.abs(w.numpy() - w_ref[sel[0] : sel[0] + sel[1]]).max() < 1e-11
    r = a @ x - (b @ x) * w.numpy()[None, :]
    assert np.abs(r).max() < 1e-12 * np.abs(a).sum(axis=1).max()


def test_refine_gevp_planar_ozaki_sweep_matches_native():
    """One fp64 sweep from the same basis: the ozaki sweep's grams and
    update equal the native sweep's within the digit products' 2^-48
    (the correction X @ E at 2^-28 of max|X| max|E| n, with |E| at the
    1e-5 level: about 1e-11): eigenvalues 1e-13, vectors 1e-11."""
    n, sel = 64, (0, 64)
    a, b = random_hpd_pair(n, seed=66)
    _, z32, _ = _perturbed_basis(a, b, 67)
    args = ((T(a.real), T(a.imag)), (T(b.real), T(b.imag)),
            (T(z32.real).double(), T(z32.imag).double()))
    kw = dict(sweeps=1, coarse_first=False, sel=sel)
    w0, (x0r, _) = refine_planar.refine_gevp_planar(*args, gemm="native", **kw)
    w1, (x1r, _) = refine_planar.refine_gevp_planar(*args, gemm="ozaki", **kw)
    assert _rel(w1, w0) < 1e-13
    assert float((x1r - x0r).abs().max()) < 1e-11


@pytest.mark.parametrize("cplx", [False, True])
def test_refine_gevp_ozaki_matches_jax_default(cplx):
    """n = 64, block (8, 24), three sweeps and escalation, real fp64 (the
    ozaki products) and complex (the plain product, as JAX's
    _resolve_mm): against the JAX default; eigenvalues within 1e-13
    relative, vectors within 1e-9."""
    n, sel = 64, (8, 24)
    a, b = (random_hpd_pair if cplx else random_spd_pair)(n, seed=68)
    w_ref, z32, w32 = _perturbed_basis(a, b, 69)
    kw = dict(sweeps=3, sel=sel, extra_max=2)
    w, x = refine.refine_gevp(T(a), T(b), T(z32), w0=T(w32), gemm="ozaki", **kw)
    jw, jx = jax_refine_gevp(a, b, z32, w0=w32, **kw)
    assert _rel(w, jw) < 1e-13
    assert compare_vectors(x.numpy(), N(jx)) < 1e-9
    assert np.abs(w.numpy() - w_ref[sel[0] : sel[0] + sel[1]]).max() < 1e-11


@pytest.mark.parametrize("sel", [None, (40, 24)])
def test_refine_eigh_ozaki_matches_jax_default(sel):
    """The standard problem at n = 64, three sweeps, escalation: against
    the JAX default; eigenvalues within 1e-13 relative, vectors 1e-9."""
    n = 64
    a, _ = random_spd_pair(n, seed=70)
    w_ref, z32, w32 = _perturbed_basis(a, np.eye(n), 71)
    w0 = None if sel is None else w32
    w, x = refine.refine_eigh(T(a), T(z32), sweeps=3, sel=sel, gemm="ozaki", extra_max=1,
                              w0=None if w0 is None else T(w0))
    jw, jx = jax_refine_eigh(a, z32, sweeps=3, sel=sel, w0=w0, extra_max=1)
    assert _rel(w, jw) < 1e-13
    assert compare_vectors(x.numpy(), N(jx)) < 1e-9
    lo, ms = sel or (0, n)
    assert np.abs(w.numpy() - w_ref[lo : lo + ms]).max() < 1e-12 * n


def _batch(pairs, seed):
    rng = np.random.default_rng(seed)
    zs, ws = [], []
    for a, b in pairs:
        w, z = scipy.linalg.eigh(a, b)
        zs.append((z + 1e-5 * rng.standard_normal(z.shape)).astype(
            np.complex64 if np.iscomplexobj(z) else np.float32).astype(z.dtype))
        ws.append(w + 1e-5 * rng.standard_normal(w.shape))
    return np.stack(zs), np.stack(ws)


@pytest.mark.parametrize("planar", [False, True])
def test_batched_refine_ozaki_matches_items_and_vmap(planar):
    """A batch of 3 at n = 48 with gemm='ozaki', block (8, 16), escalation:
    each item equal to its unbatched call (1e-13 relative); the real batch's
    w also within 1e-13 of jax.vmap of the JAX default (the planar
    unbatched call is held against JAX above)."""
    n, sel, batch = 48, (8, 16), 3
    pairs = [(random_hpd_pair if planar else random_spd_pair)(n, seed=72 + k)
             for k in range(batch)]
    z, w0 = _batch(pairs, 73)
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    kw = dict(sweeps=2, sel=sel, extra_max=2)
    if planar:
        pl = lambda x: (T(x.real), T(x.imag))
        run = lambda a, b, z, w0: refine_planar.refine_gevp_planar(
            pl(a), pl(b), pl(z), w0=T(w0), gemm="ozaki", **kw)
        jw = None
    else:
        run = lambda a, b, z, w0: refine.refine_gevp(T(a), T(b), T(z), w0=T(w0),
                                                     gemm="ozaki", **kw)
        jw, _ = jax.vmap(lambda a, b, x, w0: jax_refine_gevp(a, b, x, w0=w0, **kw))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(z), jnp.asarray(w0))
    w, x = run(a, b, z, w0)
    x = x[0].numpy() + 1j * x[1].numpy() if planar else x.numpy()
    assert w.shape == (batch, sel[1])
    assert jw is None or _rel(w, jw) < 1e-13
    for k in range(batch):
        w1, x1 = run(a[k], b[k], z[k], w0[k])
        x1 = x1[0].numpy() + 1j * x1[1].numpy() if planar else x1.numpy()
        assert _rel(w[k], w1) < 1e-13
        assert compare_vectors(x[k], x1) < 1e-10
