"""The modules of the port's real path (eigensolver_gpu_torch/ops:
jacobi, cholesky, trsm, sygst, sytrd, unmtr, refine, and stedc with its
Jacobi leaf) against their JAX twins, on the CPU.

Inputs are numpy arrays made from a seed and go to both packages. fp64
results agree to 1e-11 or better, fp32 to 1e-4 (another summation
order). Where the JAX function reaches the Pallas symv it runs in
interpret mode (``symv_auto``), and the port takes the kernel's plain
version.
"""

import sys

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import eigensolver_gpu_tpu.ops.cholesky
import eigensolver_gpu_tpu.ops.jacobi
import eigensolver_gpu_tpu.ops.refine
import eigensolver_gpu_tpu.ops.sygst
import eigensolver_gpu_tpu.ops.sytrd
import eigensolver_gpu_tpu.ops.trsm
import eigensolver_gpu_tpu.ops.unmtr
from eigensolver_gpu_tpu.ops.stedc import stedc as jax_stedc
from eigensolver_gpu_torch.ops import cholesky, jacobi, refine, sygst, sytrd, trsm, unmtr
from eigensolver_gpu_torch.ops.stedc import stedc
from eigensolver_gpu_torch.ops.symv import symv
from eigensolver_gpu_torch.utils.testing import compare_vectors, random_hpd_pair, random_spd_pair

torch.set_num_threads(2)

# the JAX ops package re-exports functions under its modules' names
# (ops.sygst is a function there), so the twins come from sys.modules
_jax = lambda name: sys.modules[f"eigensolver_gpu_tpu.ops.{name}"]
jax_cholesky, jax_jacobi, jax_refine, jax_sygst, jax_sytrd, jax_trsm, jax_unmtr = map(
    _jax, ["cholesky", "jacobi", "refine", "sygst", "sytrd", "trsm", "unmtr"]
)

T = lambda x: torch.tensor(np.ascontiguousarray(x))
N = lambda x: np.asarray(x)


def _close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got = got.resolve_conj().numpy() if isinstance(got, torch.Tensor) else N(got)
    want = N(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _tol(dtype):
    return 1e-4 if np.dtype(dtype).itemsize // (2 if np.dtype(dtype).kind == "c" else 1) == 4 else 1e-11


# --- jacobi ---------------------------------------------------------------


def test_round_robin_schedule_matches_jax():
    for m in (4, 8, 64):
        for ours, theirs in zip(jacobi._round_robin(m), jax_jacobi._round_robin(m)):
            assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("m", [8, 64])
def test_jacobi_eigh_matches_jax(m):
    """A batch of 3: eigenvalues within 1e-12 ||A|| of JAX and LAPACK,
    vectors orthogonal to 1e-12."""
    rng = np.random.default_rng(m)
    t = rng.standard_normal((3, m, m))
    a = (t + t.transpose(0, 2, 1)) / 2
    w, v = jacobi.jacobi_eigh(T(a))
    jw, _ = jax_jacobi.jacobi_eigh(a)
    anorm = np.abs(a).sum(axis=2).max()
    assert np.abs(w.numpy() - N(jw)).max() < 1e-12 * anorm
    assert np.abs(w.numpy() - np.linalg.eigvalsh(a)).max() < 1e-12 * anorm
    v = v.numpy()
    assert np.abs(v.transpose(0, 2, 1) @ v - np.eye(m)).max() < 1e-12
    assert np.abs(a @ v - v * w.numpy()[:, None, :]).max() < 1e-12 * anorm


def test_jacobi_eigh_refuses_odd_size():
    with pytest.raises(ValueError):
        jacobi.jacobi_eigh(torch.eye(5, dtype=torch.float64))


@pytest.mark.parametrize("n,leaf", [(130, 16), (256, 64), (96, 15)])
def test_stedc_fp64_jacobi_leaf_matches_jax_and_scipy(n, leaf):
    """The fp64 default leaf is the Jacobi solver (dense eigh for the odd
    leaf size), as in JAX."""
    rng = np.random.default_rng(n)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, q = stedc(T(d), T(e), leaf=leaf)
    jw, _ = jax_stedc(d, e, leaf=leaf)
    w_ref = scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)
    scale = np.abs(w_ref).max()
    assert np.abs(w.numpy() - w_ref).max() < 1e-12 * scale * n
    assert np.abs(w.numpy() - N(jw)).max() < 1e-12 * scale * n
    q = q.numpy()
    tri = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-11 * n
    assert np.abs(tri @ q - q * w.numpy()).max() < 1e-11 * scale * n


# --- cholesky -------------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
def test_cholesky_upper_matches_jax(cplx):
    _, b = (random_hpd_pair if cplx else random_spd_pair)(48, seed=20)
    u, info = cholesky.cholesky_upper(T(b))
    ju, jinfo = jax_cholesky.cholesky_upper(b)
    _close(u, ju, 1e-12)
    assert int(info) == int(jinfo) == 0
    assert info.dtype == torch.int32 and info.ndim == 0
    assert np.abs(u.numpy().conj().T @ u.numpy() - b).max() < 1e-12 * np.abs(b).max()


def test_cholesky_info_convention_on_non_pd():
    """info = 1-based first bad row (LAPACK/cuSOLVER devInfo). With the
    bad pivot in row 1 both packages report 1. With it in row 10 the port
    reports 10; the JAX function on the CPU backend reports 1, because
    XLA's CPU Cholesky turns the WHOLE factor NaN on failure and the
    first-bad-row scan then stops at row 1 -- both are > 0, which is all
    the drivers' callers test."""
    _, b = random_spd_pair(32, seed=21)
    first = b.copy()
    first[0, 0] = -50.0
    assert int(cholesky.cholesky_upper(T(first))[1]) == 1
    assert int(jax_cholesky.cholesky_upper(first)[1]) == 1
    tenth = b.copy()
    tenth[9, 9] = -50.0
    assert int(cholesky.cholesky_upper(T(tenth))[1]) == 10
    assert int(jax_cholesky.cholesky_upper(tenth)[1]) > 0
    nan = b.copy()
    nan[4, 4] = np.nan
    assert int(cholesky.cholesky_upper(T(nan))[1]) > 0


# --- trsm -----------------------------------------------------------------


def _upper(n, dtype, seed=30):
    """A well-conditioned upper-triangular factor and a right-hand side."""
    make = random_hpd_pair if np.dtype(dtype).kind == "c" else random_spd_pair
    _, b = make(n, seed=seed)
    u = np.linalg.cholesky(b).conj().T.astype(dtype)
    rng = np.random.default_rng(seed + 1)
    rhs = rng.standard_normal((n, 24))
    if np.dtype(dtype).kind == "c":
        rhs = rhs + 1j * rng.standard_normal((n, 24))
    return np.ascontiguousarray(u), rhs.astype(dtype)


_DTYPES = [np.float32, np.float64, np.complex128]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_trinv_lower_batched_and_block_inverses_match_jax(dtype):
    u, _ = _upper(128, dtype)
    blocks = np.stack([u[k : k + 64, k : k + 64].T for k in (0, 64)])
    got = trsm._trinv_lower_batched(T(blocks))
    _close(got, jax_trsm._trinv_lower_batched(blocks), _tol(dtype))
    eye = np.broadcast_to(np.eye(64), (2, 64, 64))
    assert np.abs(blocks @ got.numpy() - eye).max() < 10 * _tol(dtype)
    _close(trsm.upper_block_inverses(T(u), 32), jax_trsm.upper_block_inverses(u, 32),
           _tol(dtype))
    with pytest.raises(ValueError):
        trsm._trinv_lower_batched(torch.zeros((1, 48, 48)))


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize(
    "name", ["trsm_left_upper_inv", "trsm_left_upper_trans_inv", "trsm_right_upper_inv"]
)
def test_blocked_solves_match_jax(name, dtype):
    u, rhs = _upper(96, dtype)
    if name == "trsm_right_upper_inv":
        rhs = np.ascontiguousarray(rhs.T)
    got = getattr(trsm, name)(T(u), T(rhs), nb=32)
    _close(got, getattr(jax_trsm, name)(u, rhs, nb=32), _tol(dtype))
    x = got.numpy()
    back = {"trsm_left_upper_inv": lambda: u @ x,
            "trsm_left_upper_trans_inv": lambda: u.conj().T @ x,
            "trsm_right_upper_inv": lambda: x @ u}[name]()
    assert np.abs(back - rhs).max() < 10 * _tol(dtype) * np.abs(rhs).max()
    with pytest.raises(ValueError):
        getattr(trsm, name)(T(u), T(rhs), nb=64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_trinv_upper_full_matches_jax(dtype):
    u, _ = _upper(128, dtype)
    got = trsm.trinv_upper_full(T(u), base=32)
    _close(got, jax_trsm.trinv_upper_full(u, base=32), _tol(dtype))
    assert np.abs(got.numpy() @ u - np.eye(128)).max() < 10 * _tol(dtype)
    with pytest.raises(ValueError):
        trsm.trinv_upper_full(T(u[:96, :96]), base=32)


@pytest.mark.parametrize("dtype,nb", [(np.float32, 32), (np.float32, 512), (np.float64, 32)])
def test_trsm_phase4_matches_jax(dtype, nb):
    """fp32 with a compatible nb takes the inverse-diagonal scheme; an
    incompatible nb and fp64 take exact substitution."""
    u, rhs = _upper(96, dtype)
    got = trsm.trsm_phase4(T(u), T(rhs), nb=nb)
    _close(got, jax_trsm.trsm_phase4(u, rhs, nb=nb), _tol(dtype))
    assert np.abs(u @ got.numpy() - rhs).max() < 10 * _tol(dtype) * np.abs(rhs).max()


# --- sygst ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("mode,nb", [("full", 512), ("blocked", 32), ("blocked", 40), ("inv", 32)])
def test_sygst_modes_match_jax_and_each_other(mode, nb, dtype):
    """nb=40 does not divide n=96: the ragged last block here, zero/identity
    padding in JAX."""
    cplx = np.dtype(dtype).kind == "c"
    a, b = (random_hpd_pair if cplx else random_spd_pair)(96, seed=40)
    a, b = a.astype(dtype), b.astype(dtype)
    u = np.ascontiguousarray(np.linalg.cholesky(b).conj().T)
    got = sygst.sygst(T(a), T(u), mode=mode, nb=nb)
    _close(got, jax_sygst.sygst(a, u, mode=mode, nb=nb), 10 * _tol(dtype))
    _close(got, sygst.sygst_full(T(a), T(u)), 10 * _tol(dtype))
    c = got.numpy()
    assert np.abs(c - c.conj().T).max() == 0
    assert np.abs(u.conj().T @ c @ u - a).max() < 100 * _tol(dtype) * np.abs(a).max()


# --- sytrd / unmtr --------------------------------------------------------


def _spectrum_ok(out, a):
    """The tridiagonal (d, e) has A's spectrum to 1e-4 ||A|| (fp32) or
    1e-12 n ||A|| (fp64): backward stability of the reduction."""
    d, e = out[1].double().numpy(), out[2].double().numpy()
    w = scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)
    w_ref = np.linalg.eigvalsh(a.astype(np.complex128 if np.iscomplexobj(a) else np.float64))
    tol = 1e-4 if out[1].dtype == torch.float32 else 1e-12 * a.shape[0]
    assert np.abs(w - w_ref).max() < tol * np.abs(w_ref).max()


def _fp32_reduction_close(got, want, nb=32):
    """fp32 reductions (packed, d, e, tau) against each other. The map
    A -> (d, e, reflectors) is ill-conditioned: two correct fp32
    reductions (either package, or LAPACK ssytrd) drift apart by
    1e-3..1e-2 in d and e towards the columns reduced last, and a pivot
    near zero flips a reflector's sign. So the first panel (the last nb
    columns, a few hundred flops deep) is held to 1e-4 elementwise, and
    d and |e| as a whole to 5e-2; the spectrum and the reconstruction
    checks carry the rest."""
    for g, w in zip(got, want):
        g, w = N(g), N(w)
        if g.ndim == 2:
            g, w = np.triu(g), np.triu(w)
        _close(g[..., -(nb - 1):], w[..., -(nb - 1):], 1e-4)
    _close(got[1], want[1], 5e-2)
    _close(np.abs(N(got[2])), np.abs(N(want[2])), 5e-2)


def _sytrd_pair(a, **kw):
    got = sytrd.sytrd(T(a), **kw)
    want = jax_sytrd.sytrd(a, **kw)
    return [x.numpy() for x in got], want


@pytest.mark.parametrize("dtype", _DTYPES)
def test_sytrd_matches_jax(dtype):
    """n=96, buckets of 64 (so one bucket is a strided view), nb=32: d, e,
    tau and the whole packed matrix against JAX, and d, e, tau against
    LAPACK, to 1e-11 in fp64; fp32 as _fp32_reduction_close says. The
    tridiagonal keeps A's spectrum in every dtype."""
    cplx = np.dtype(dtype).kind == "c"
    a, _ = (random_hpd_pair if cplx else random_spd_pair)(96, seed=50)
    a = a.astype(dtype)
    got, want = _sytrd_pair(a, nb=32, bucket=64)
    assert got[1].dtype == got[2].dtype == got[0].real.dtype
    _spectrum_ok([torch.from_numpy(x) for x in got], a)
    if dtype == np.float32:
        _fp32_reduction_close(got, want)
        return
    for g, w in zip(got, want):
        _close(g, w, 1e-11)
    f = scipy.linalg.lapack.zhetrd if cplx else scipy.linalg.lapack.dsytrd
    _, d_ref, e_ref, tau_ref, info = f(a, lower=0)
    assert info == 0
    _close(got[1], d_ref, 1e-11)
    _close(got[2], e_ref, 1e-11)
    _close(got[3], tau_ref, 1e-11)


def test_sytrd_use_pallas_takes_the_symv_branch_on_both_sides():
    """fp32 n=512, bucket=256: the mb=512 bucket passes the JAX gate, so
    JAX runs the Pallas symv (interpret mode) and the port the symv
    wrapper (plain version on the CPU) on its 256 columns, each on the
    leading cj x cj block. The reflectors rebuild A to 1e-4 ||A||."""
    n = 512
    a, _ = random_spd_pair(n, seed=51, dtype=np.float32)
    calls = []
    real_symv = sytrd.symv
    sytrd.symv = lambda *args, **kw: (calls.append(kw.get("extent")), real_symv(*args, **kw))[1]
    try:
        got, want = _sytrd_pair(a, nb=32, bucket=256, use_pallas=True)
    finally:
        sytrd.symv = real_symv
    assert real_symv is symv
    assert calls == list(range(511, 255, -1))
    _fp32_reduction_close(got, want)
    _fp32_reduction_close(got, sytrd.sytrd(T(a), nb=32, bucket=256, use_pallas=False))
    packed, d, e, tau = (torch.from_numpy(x) for x in got)
    _spectrum_ok((packed, d, e, tau), a)
    q = unmtr.ungtr(packed, tau).numpy().astype(np.float64)
    tri = np.diag(d.numpy()) + np.diag(e.numpy(), 1) + np.diag(e.numpy(), -1)
    assert np.abs(q @ tri @ q.T - a).max() < 1e-4 * np.abs(a).sum(axis=1).max()


def test_sytrd_refuses_ragged_n():
    with pytest.raises(ValueError):
        sytrd.sytrd(torch.eye(40, dtype=torch.float64), nb=32)


@pytest.mark.parametrize("cplx", [False, True])
def test_unmtr_and_ungtr_match_jax(cplx):
    """Q from the packed reflectors: against JAX to 1e-11, unitary, and
    Q T Q^H = A; a partial block of columns goes through unmtr."""
    n = 96
    a, _ = (random_hpd_pair if cplx else random_spd_pair)(n, seed=52)
    packed, d, e, tau = sytrd.sytrd(T(a), nb=32, bucket=64)
    q = unmtr.ungtr(packed, tau, nb=40)  # ragged last block
    jq = jax_unmtr.ungtr(packed.numpy(), tau.numpy(), nb=40)
    _close(q, jq, 1e-11)
    q = q.numpy()
    tri = np.diag(d.numpy()) + np.diag(e.numpy(), 1) + np.diag(e.numpy(), -1)
    assert np.abs(q.conj().T @ q - np.eye(n)).max() < 1e-12 * n
    assert np.abs(q @ tri @ q.conj().T - a).max() < 1e-11 * n
    rng = np.random.default_rng(53)
    c = rng.standard_normal((n, 7)).astype(a.dtype)
    _close(unmtr.unmtr(packed, tau, T(c), nb=32), q @ c, 1e-11)
    v = unmtr._block_v(packed, 32, 32, n - 1)
    t1 = unmtr._larft_left(v, tau[32:64])
    _close(t1, jax_unmtr._larft_left(jnp.asarray(v.numpy()), jnp.asarray(tau.numpy()[32:64])),
           1e-11)


# --- refine ---------------------------------------------------------------


def _perturbed_basis(a, b, seed):
    """The exact generalized eigenbasis, rounded to fp32 and perturbed at
    the 1e-5 level: what an fp32 pipeline hands to the refinement."""
    w, z = scipy.linalg.eigh(a, b)
    rng = np.random.default_rng(seed)
    z32 = (z + 1e-5 * rng.standard_normal(z.shape)).astype(
        np.complex64 if np.iscomplexobj(z) else np.float32
    )
    return w, z32, (w + 1e-5 * rng.standard_normal(w.shape)).astype(np.float32)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("kw", [dict(sweeps=2), dict(sweeps=3, extra_max=2),
                                dict(sweeps=1, coarse_first=False)])
def test_refine_gevp_matches_jax(cplx, kw):
    n, sel = 64, (8, 24)
    a, b = (random_hpd_pair if cplx else random_spd_pair)(n, seed=60)
    w_ref, z32, w32 = _perturbed_basis(a, b, 61)
    w, x = refine.refine_gevp(T(a), T(b), T(z32), sel=sel, w0=T(w32), **kw)
    jw, jx = jax_refine.refine_gevp(a, b, z32, sel=sel, w0=w32, gemm="emulated", **kw)
    assert x.shape == (n, sel[1]) and w.dtype == torch.float64
    _close(w, jw, 1e-12)
    # the coarse fp32 sweeps round differently in the two packages, which
    # leaves a free column phase and a 1e-10-level residual difference
    # after two sweeps: vectors are compared phase-insensitively
    assert compare_vectors(x.numpy(), N(jx)) < 1e-9
    res = lambda w, x: np.abs(a @ N(x) - (b @ N(x)) * N(w)).max()
    assert res(w.numpy(), x.numpy()) < 3 * res(jw, jx) + 1e-12
    if kw["sweeps"] > 1:
        assert np.abs(w.numpy() - w_ref[sel[0] : sel[0] + sel[1]]).max() < 1e-11
    else:
        _close(x, jx, 1e-12)


@pytest.mark.parametrize("sel", [None, (40, 24)])
def test_refine_eigh_matches_jax(sel):
    n = 64
    a, _ = random_spd_pair(n, seed=62)
    w_ref, z32, w32 = _perturbed_basis(a, np.eye(n), 63)
    w0 = None if sel is None else T(w32)
    w, x = refine.refine_eigh(T(a), T(z32), sweeps=3, sel=sel, w0=w0, extra_max=1)
    jw, jx = jax_refine.refine_eigh(a, z32, sweeps=3, sel=sel, gemm="emulated",
                                    w0=None if sel is None else w32, extra_max=1)
    _close(w, jw, 1e-12)
    _close(x, jx, 1e-11)
    lo, ms = sel or (0, n)
    assert np.abs(w.numpy() - w_ref[lo : lo + ms]).max() < 1e-12 * n
    assert np.abs(a @ x.numpy() - x.numpy() * w.numpy()).max() < 1e-12 * n


def test_refine_argument_checks():
    """gemm='ozaki' (once NotImplementedError) refines as the JAX default
    does (one fp64 sweep at n = 8, eigenvalues within 1e-13 of JAX's); an
    unknown gemm and a strict-subset sel without w0 are ValueErrors."""
    x = torch.eye(8, dtype=torch.float64)
    a, b = random_spd_pair(8, seed=64)
    kw = dict(sweeps=1, coarse_first=False)
    w, _ = refine.refine_gevp(T(a), T(b), x, gemm="ozaki", **kw)
    jw, _ = jax_refine.refine_gevp(a, b, np.eye(8), **kw)
    _close(w, jw, 1e-13)
    w, _ = refine.refine_eigh(T(a), x, gemm="ozaki", **kw)
    jw, _ = jax_refine.refine_eigh(a, np.eye(8), **kw)
    _close(w, jw, 1e-13)
    with pytest.raises(ValueError):
        refine.refine_eigh(x, x, gemm="bf16")
    with pytest.raises(ValueError):
        refine.refine_gevp(x, x, x, sel=(0, 4))  # strict subset needs w0
    a = torch.arange(64, dtype=torch.float64).reshape(8, 8)
    assert torch.equal(refine._mm_chunked(a, a, 2), a @ a)
    assert torch.equal(refine._mm_chunked(a, a, 3), a @ a)
