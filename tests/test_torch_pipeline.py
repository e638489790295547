"""The port's planar pipeline (eigensolver_gpu_torch) against the JAX
package, stage by stage and end to end, on the CPU.

Inputs are numpy arrays made from a seed and go to both packages; the
port runs on CPU tensors (the kernels' plain versions), the JAX package
through its XLA branches and, for the latrd panel, its Pallas kernel in
interpret mode. The three end-to-end cases share one JAX compile (same
shapes and static arguments): JAX's pure fp64 solve, whose compile takes
seconds where its mixed driver's takes over a minute (most of it the
ozaki refinement's graph); both are fp64-accurate, which is what the bars
hold. The JAX ozaki refinement is evaluated op by op (``jax.disable_jit``),
which gives the jitted function's bits without its compile.
"""

import jax
import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_host as jax_zhegvdx
from eigensolver_gpu_tpu.ops.planar import pcholesky_lower as jax_pchol
from eigensolver_gpu_tpu.ops.refine_planar import refine_gevp_planar as jax_refine_planar
from eigensolver_gpu_tpu.ops.stedc import stedc as jax_stedc
from eigensolver_gpu_tpu.ops.sytrd_planar import hetrd_planar as jax_hetrd
from eigensolver_gpu_tpu.ops.unmtr_planar import unmtr_planar as jax_unmtr
from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar_host
from eigensolver_gpu_torch.ops.planar import (
    pcholesky_lower,
    pmatmul_chunked,
    ptrsm_left_lower,
    ptrsm_left_lower_inv,
    ptrsm_left_upper,
)
from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
from eigensolver_gpu_torch.ops.stedc import stedc
from eigensolver_gpu_torch.ops.sytrd_planar import hetrd_planar
from eigensolver_gpu_torch.ops.unmtr_planar import unmtr_planar
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    ge_residual,
    qe_style_pair,
    random_hpd_pair,
)

torch.set_num_threads(2)

T = lambda x, dt=torch.float64: torch.tensor(np.ascontiguousarray(x), dtype=dt)


def test_hetrd_planar_fp32_kernel_path_matches_jax():
    """fp32 n=512, bucket=128, use_pallas=True: buckets 256 and 512 take
    the latrd panel (Pallas interpret in JAX, the plain version here),
    128 and 384 the column loop. d, e within rtol 1e-4 / atol 1e-3."""
    n = 512
    a, _ = random_hpd_pair(n, seed=98)
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    _, d0, e0, (tr0, ti0) = jax_hetrd(ar, ai, nb=32, bucket=128, use_pallas=True)
    _, d1, e1, (tr1, ti1) = hetrd_planar(T(ar, torch.float32), T(ai, torch.float32),
                                         nb=32, bucket=128, use_pallas=True)
    np.testing.assert_allclose(d1.numpy(), np.asarray(d0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(e1.numpy(), np.asarray(e0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tr1.numpy(), np.asarray(tr0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ti1.numpy(), np.asarray(ti0), rtol=1e-4, atol=1e-3)


def test_hetrd_planar_fp64_and_unmtr_match_jax():
    """fp64 n=64: d within 1e-12 n of JAX and of LAPACK zhetrd; the
    back-transform rebuilds A from the tridiagonal."""
    n = 64
    a, _ = random_hpd_pair(n, seed=91)
    (pr, pi), d, e, (tr, ti) = hetrd_planar(T(a.real), T(a.imag), nb=32, bucket=64)
    (jpr, jpi), jd, je, (jtr, jti) = jax_hetrd(a.real.copy(), a.imag.copy(), nb=32, bucket=64)
    _, d_ref, _, _, info = scipy.linalg.lapack.zhetrd(a, lower=0)
    assert info == 0
    assert np.abs(d.numpy() - np.asarray(jd)).max() < 1e-12 * n
    assert np.abs(d.numpy() - d_ref).max() < 1e-12 * n
    assert np.abs(e.numpy() - np.asarray(je)).max() < 1e-12 * n
    eye = np.eye(n)
    zr, zi = unmtr_planar(pr, pi, tr, ti, T(eye), T(np.zeros((n, n))), nb=32)
    jzr, jzi = jax_unmtr(jpr, jpi, jtr, jti, eye, np.zeros((n, n)), nb=32)
    q = zr.numpy() + 1j * zi.numpy()
    assert np.abs(q - (np.asarray(jzr) + 1j * np.asarray(jzi))).max() < 1e-12 * n
    tri = np.diag(d.numpy()) + np.diag(e.numpy(), 1) + np.diag(e.numpy(), -1)
    assert np.abs(q @ tri @ q.conj().T - a).max() < 1e-11 * n


def test_stedc_fp32_matches_jax_and_scipy():
    """fp32 n=256 (4 leaves, 2 merge levels + the fixed 35-step secular
    iteration): eigenvalues within 64 eps32 ||T|| of scipy and of JAX,
    orthogonal vectors, small residual."""
    n = 256
    rng = np.random.default_rng(11)
    d = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    w, q = stedc(T(d, torch.float32), T(e, torch.float32))
    jw, _ = jax_stedc(d, e)
    w_ref = scipy.linalg.eigh_tridiagonal(d.astype(np.float64), e.astype(np.float64),
                                          eigvals_only=True)
    tnorm = np.abs(w_ref).max()
    tol = 64 * np.finfo(np.float32).eps * tnorm
    assert np.abs(w.numpy() - w_ref).max() < tol
    assert np.abs(w.numpy() - np.asarray(jw)).max() < tol
    q = q.numpy().astype(np.float64)
    tri = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-4
    assert np.abs(tri @ q - q * w.numpy()).max() < tol


def test_stedc_fp64_needs_the_jacobi_leaf():
    """fp64 takes the Jacobi leaf by default, as in JAX; it agrees with
    the dense-eigh leaf, and an unknown leaf solver is refused."""
    d = torch.ones(128, dtype=torch.float64)
    e = torch.ones(127, dtype=torch.float64)
    w, q = stedc(d, e)
    w_xla, _ = stedc(d, e, leaf_solver="xla")
    assert torch.allclose(w, w_xla, rtol=0, atol=1e-12)
    assert torch.allclose(q.T @ q, torch.eye(128, dtype=torch.float64), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        stedc(d, e, leaf_solver="qr")
    w, _ = stedc(d, torch.zeros(127, dtype=torch.float64), leaf_solver="xla")
    assert torch.allclose(w, torch.ones_like(w))


@pytest.mark.parametrize("dt,n,nb", [(np.float64, 256, 128), (np.float32, 256, 128),
                                      (np.float32, 200, 100)])
def test_pcholesky_and_solves_match_jax(dt, n, nb):
    """fp64 takes the substitution path on both sides; fp32 the K1 path
    here (plain version, also at an nb that is not a multiple of 8) and
    the XLA base loops in JAX. L within the dtype's tolerance; the
    triangular solves invert L."""
    _, b = random_hpd_pair(n, seed=12)
    br, bi = b.real.astype(dt), b.imag.astype(dt)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    before = pchol_block_planar.launches
    (lr, li), info = pcholesky_lower((T(br, tdt), T(bi, tdt)), nb=nb)
    assert pchol_block_planar.launches == before  # CPU tensors never launch K1
    (jlr, jli), jinfo = jax_pchol((br, bi), nb=nb)
    tol = 1e-12 if dt == np.float64 else 1e-5
    scale = np.abs(np.asarray(jlr)).max()
    assert int(info) == int(jinfo) == 0
    assert np.abs(lr.numpy() - np.asarray(jlr)).max() < tol * scale
    assert np.abs(li.numpy() - np.asarray(jli)).max() < tol * scale
    l = lr.numpy().astype(np.float64) + 1j * li.numpy()
    rng = np.random.default_rng(13)
    rhs = rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
    args = ((lr, li), (T(rhs.real, tdt), T(rhs.imag, tdt)))
    ur, ui = lr.T.contiguous(), -li.T.contiguous()
    for solve in (ptrsm_left_lower, ptrsm_left_lower_inv):
        xr, xi = solve(*args, nb=nb)
        x = xr.numpy() + 1j * xi.numpy()
        assert np.abs(l @ x - rhs).max() < 100 * tol
        xr, xi = ptrsm_left_upper((ur, ui), args[1], nb=nb, solve_lower=solve)
        x = xr.numpy() + 1j * xi.numpy()
        assert np.abs(l.conj().T @ x - rhs).max() < 100 * tol


def test_pmatmul_chunked_matches_pmatmul():
    rng = np.random.default_rng(14)
    x = (T(rng.standard_normal((16, 16))), T(rng.standard_normal((16, 16))))
    y = (T(rng.standard_normal((16, 8))), T(rng.standard_normal((16, 8))))
    a = pmatmul_chunked(x, y, 2)
    b = pmatmul_chunked(x, y, None)
    assert torch.allclose(a[0], b[0]) and torch.allclose(a[1], b[1])


_MIXED = dict(compute_dtype="float32", refine_iters=2)
N_SLICE, IU_SLICE = 128, 32


def _non_pd(n):
    a, b = random_hpd_pair(n, seed=97)
    b = b.copy()
    b[9, 9] = -50.0
    return a, b


_CASES = {
    "random": lambda n: random_hpd_pair(n, seed=96),
    "qe": lambda n: qe_style_pair(n, seed=94),
    "non_pd": _non_pd,
}


@pytest.fixture(scope="module")
def jax_slice():
    """JAX results for the three end-to-end cases (one compile of its pure
    fp64 driver, see the module docstring)."""
    out = {}
    for name, make in _CASES.items():
        a, b = make(N_SLICE)
        w, zr, zi, info = jax_zhegvdx(a, b, il=1, iu=IU_SLICE, cfg=JaxConfig())
        out[name] = (a, b, np.asarray(w), np.asarray(zr) + 1j * np.asarray(zi), int(info))
    return out


@pytest.mark.parametrize("case", ["random", "qe"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_zhegvdx_mixed_matches_jax(jax_slice, case, use_pallas):
    """The whole slice, n=128, il=1..iu=32, fp32 pipeline + fp64
    refinement: eigenvalues within 1e-10 n of JAX's fp64 solve,
    ge_residual < 1e-12, vectors within 1e-8 of JAX's (phase-insensitive),
    same info."""
    a, b, jw, jz, jinfo = jax_slice[case]
    cfg = SolverConfig(use_pallas=use_pallas, **_MIXED)
    w, zr, zi, info = zhegvdx_planar_host(a, b, il=1, iu=IU_SLICE, cfg=cfg, device="cpu")
    w = w.numpy()
    z = zr.numpy() + 1j * zi.numpy()
    assert int(info) == jinfo == 0
    assert w.shape == (IU_SLICE,) and z.shape == (N_SLICE, IU_SLICE)
    assert np.abs(w - jw).max() < 1e-10 * N_SLICE
    assert ge_residual(a, b, w, z) < 1e-12
    assert compare_vectors(z, jz) <= 1e-8


def test_zhegvdx_mixed_info_on_non_pd_b(jax_slice):
    """A non-positive-definite B: the same devInfo column as JAX, > 0,
    and no exception."""
    a, b, _, _, jinfo = jax_slice["non_pd"]
    res = zhegvdx_planar_host(a, b, il=1, iu=IU_SLICE, cfg=SolverConfig(**_MIXED),
                              device="cpu")
    assert int(res.info) == jinfo > 0
    assert res.info.dtype == torch.int32


def test_zhegvdx_fp64_branch_with_dense_tridiagonal_eigh():
    """The pure fp64 branch (substitution solves, fp64 hetrd) runs with
    stedc_backend='xla' until the fp64 Jacobi leaf is ported."""
    n, iu = 64, 12
    a, b = random_hpd_pair(n, seed=93)
    w, zr, zi, info = zhegvdx_planar_host(
        a, b, il=3, iu=iu, cfg=SolverConfig(stedc_backend="xla"), device="cpu"
    )
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)[2:iu]
    assert int(info) == 0
    assert np.abs(w.numpy() - w_ref).max() < 1e-10 * n
    assert ge_residual(a, b, w.numpy(), zr.numpy() + 1j * zi.numpy()) < 1e-12


def test_zhegvdx_uplo_contract():
    """UPLO='U': the strict lower triangles are never read."""
    n, iu = 64, 8
    a, b = random_hpd_pair(n, seed=97)
    cfg = SolverConfig(**_MIXED)
    w0, zr0, zi0, _ = zhegvdx_planar_host(a, b, il=1, iu=iu, cfg=cfg, device="cpu")
    rng = np.random.default_rng(98)
    trash = lambda x: x + 1e3 * np.tril(rng.standard_normal((n, n)), -1)
    w1, zr1, zi1, info = zhegvdx_planar_host(trash(a), trash(b), il=1, iu=iu, cfg=cfg,
                                             device="cpu")
    assert int(info) == 0
    assert torch.allclose(w0, w1, atol=1e-11 * n)


@pytest.mark.parametrize("kw", [dict(planar_solve_mode="trinv")], ids=["trinv"])
def test_unported_options_raise(kw):
    """Options that once raised NotImplementedError now solve as the JAX
    package does: 'trinv' at n = 32 in fp64 misses its gate (fp32, n / 128
    a power of two) and takes the exact substitution in both packages;
    eigenvalues within 1e-12 of JAX's, vectors within 1e-9 (the gated
    route itself: tests/test_torch_trinv.py)."""
    a, b = random_hpd_pair(32, seed=99)
    res = zhegvdx_planar_host(a, b, il=1, iu=4, cfg=SolverConfig(**kw), device="cpu")
    jw, jzr, jzi, jinfo = jax_zhegvdx(a, b, il=1, iu=4, cfg=JaxConfig(**kw))
    assert int(res.info) == int(jinfo) == 0
    assert np.abs(res.w.numpy() - np.asarray(jw)).max() < 1e-12
    z = res.zr.numpy() + 1j * res.zi.numpy()
    assert compare_vectors(z, np.asarray(jzr) + 1j * np.asarray(jzi)) < 1e-9


def test_refine_ozaki_raises():
    """gemm='ozaki' (once NotImplementedError) refines as the JAX default
    does: one fp64 ozaki sweep of a perturbed basis at n = 16, eigenvalues
    within 1e-13 relative of JAX's; an unknown gemm is a ValueError."""
    n = 16
    a, b = random_hpd_pair(n, seed=100)
    w_ref, z = scipy.linalg.eigh(a, b)
    z = z + 1e-6 * np.random.default_rng(101).standard_normal(z.shape)
    pl = lambda x: (T(x.real), T(x.imag))
    kw = dict(sweeps=1, coarse_first=False)
    w, _ = refine_gevp_planar(pl(a), pl(b), pl(z), gemm="ozaki", **kw)
    with jax.disable_jit():  # the jitted function's bits, without its minute of compile
        jw, _ = jax_refine_planar((a.real, a.imag), (b.real, b.imag), (z.real, z.imag), **kw)
    assert np.abs(w.numpy() - np.asarray(jw)).max() < 1e-13 * np.abs(w_ref).max()
    # the Rayleigh quotients of a basis perturbed at 1e-6: LAPACK's to 1e-9
    assert np.abs(w.numpy() - w_ref).max() < 1e-9
    with pytest.raises(ValueError):
        refine_gevp_planar(pl(a), pl(b), pl(z), gemm="bf16")


def test_range_validation():
    a, b = random_hpd_pair(32, seed=99)
    for il, iu in [(0, 8), (5, 4), (1, 33)]:
        with pytest.raises(ValueError):
            zhegvdx_planar_host(a, b, il=il, iu=iu, device="cpu")
