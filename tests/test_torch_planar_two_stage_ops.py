"""The port's planar two-stage reduction (eigensolver_gpu_torch/ops/
sbrd_planar.py, ops/sb2st_planar.py, ops/replay.window_qs_planar) stage by
stage against the JAX package's, on the CPU; and the repair of the planar
Cholesky's ``block_kernel`` argument.

The same numpy inputs, made from a seed, go through the JAX function and
its torch twin, in fp64, and the outputs are held elementwise to 1e-11
(both packages do the same arithmetic; only the order inside library sums
differs). JAX stage outputs cross into the port's next stage through the
carriers of utils/convert.py.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu.ops.planar import pcholesky_lower as jax_pchol
from eigensolver_gpu_tpu.ops.replay_pallas import window_qs_planar as jax_window_qs_planar
from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar_host
from eigensolver_gpu_torch.ops import planar as t_planar
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.ops import sb2st_planar as t_sb2st_planar
from eigensolver_gpu_torch.ops import sbrd_planar as t_sbrd_planar
from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
from eigensolver_gpu_torch.utils.convert import (
    planar_band_from_numpy,
    planar_chase_from_numpy,
    psbrd_from_numpy,
)
from eigensolver_gpu_torch.utils.testing import random_hpd_pair

# the JAX ops package re-exports functions under its modules' names
j_sb2st = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st")
j_sb2st_planar = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st_planar")
j_sbrd_planar = importlib.import_module("eigensolver_gpu_tpu.ops.sbrd_planar")

torch.set_num_threads(2)

TOL64 = 1e-11
PSBRD_CASES = [(96, 8), (128, 16), (120, 8)]
CHASE_CASES = [(24, 4), (96, 8), (120, 8)]


def _err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


def _pair(x):
    return np.asarray(x[0]), np.asarray(x[1])


def _herm(n, seed, b=None):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (t + t.conj().T) / 2
    if b is not None:
        a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    return a


def _planes(a):
    return torch.tensor(a.real.copy()), torch.tensor(a.imag.copy())


@functools.lru_cache(maxsize=None)
def _jax_psbrd(n, b):
    a = _herm(n, 210)
    out = j_sbrd_planar.psbrd(jnp.asarray(a.real.copy()), jnp.asarray(a.imag.copy()), band=b)
    return a, tuple(_pair(x) for x in out)


@functools.lru_cache(maxsize=None)
def _jax_chase(n, b):
    a = _herm(n, 211, b)
    band = tuple(np.asarray(j_sb2st.dense_to_band(jnp.asarray(x.copy()), b))
                 for x in (a.real, a.imag))
    d, e, vt, taut = j_sb2st_planar.bulge_chase_planar(*band, b)
    return a, band, (np.asarray(d), _pair(e), _pair(vt), _pair(taut))


@pytest.mark.parametrize("panel_kernel", [True, False], ids=["wrapper", "plain"])
@pytest.mark.parametrize("n,b", PSBRD_CASES)
def test_psbrd_matches_jax(n, b, panel_kernel):
    """Band, vs and ts, both planes, elementwise; on CPU tensors the panel
    wrapper takes its plain version, so both routes give the same factors.
    Then what a band reduction must satisfy: Q1 ab Q1^H = a."""
    a, want = _jax_psbrd(n, b)
    got = t_sbrd_planar.psbrd(*_planes(a), band=b, panel_kernel=panel_kernel)
    for g, w in zip(got, want):
        for plane in (0, 1):
            assert tuple(g[plane].shape) == w[plane].shape and g[plane].dtype == torch.float64
            assert _err(g[plane], w[plane]) < TOL64
    (abr, abi), vs, ts = got
    ab = abr.numpy() + 1j * abi.numpy()
    outside = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b
    assert np.abs(ab[outside]).max() < 1e-12 * n and np.abs(ab - ab.conj().T).max() < 1e-12 * n
    eye = (torch.eye(n, dtype=torch.float64), torch.zeros((n, n), dtype=torch.float64))
    q1r, q1i = t_sbrd_planar.apply_q1_planar(vs, ts, eye)
    q1 = q1r.numpy() + 1j * q1i.numpy()
    assert np.abs(q1 @ q1.conj().T - np.eye(n)).max() < 1e-12 * n
    assert np.abs(q1 @ ab @ q1.conj().T - a).max() < 1e-11 * n


@pytest.mark.parametrize("n,band", [(64, 48), (100, 32), (32, 16)])
def test_psbrd_rejects_what_jax_rejects(n, band):
    eye, zero = np.eye(n), np.zeros((n, n))
    with pytest.raises(ValueError):
        t_sbrd_planar.psbrd(torch.tensor(eye), torch.tensor(zero), band=band)
    with pytest.raises(ValueError):
        j_sbrd_planar.psbrd(eye, zero, band=band)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("n,b", PSBRD_CASES[:2])
def test_apply_q1_planar_matches_jax(n, b, group):
    """The JAX factors, carried over, replayed by the port."""
    _, (ab, vs, ts) = _jax_psbrd(n, b)
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((n, 9)), rng.standard_normal((n, 9)))
    _, tvs, tts = psbrd_from_numpy(ab, vs, ts, b, device="cpu")
    got = t_sbrd_planar.apply_q1_planar(tvs, tts, (torch.tensor(y[0]), torch.tensor(y[1])),
                                        group=group)
    want = j_sbrd_planar.apply_q1_planar(vs, ts, y, group=group)
    assert _err(got[0], want[0]) < TOL64 and _err(got[1], want[1]) < TOL64


@pytest.mark.parametrize("n,b", CHASE_CASES)
def test_bulge_chase_planar_matches_jax(n, b):
    """d, e, vt and taut, both planes, elementwise in fp64."""
    _, band, want = _jax_chase(n, b)
    got = t_sb2st_planar.bulge_chase_planar(*planar_band_from_numpy(*band, b, device="cpu"), b)
    assert tuple(got[0].shape) == want[0].shape and _err(got[0], want[0]) < TOL64
    for g, w in zip(got[1:], want[1:]):
        for plane in (0, 1):
            assert tuple(g[plane].shape) == w[plane].shape
            assert _err(g[plane], w[plane]) < TOL64
    # the chased matrix is tridiagonal with a real diagonal and keeps the spectrum
    a = _jax_chase(n, b)[0]
    e = got[1][0].numpy() + 1j * got[1][1].numpy()
    tri = np.diag(got[0].numpy()).astype(complex) + np.diag(e, -1) + np.diag(e.conj(), 1)
    assert np.abs(np.linalg.eigvalsh(tri) - np.linalg.eigvalsh(a)).max() < 1e-11 * n


def test_bulge_chase_planar_rejects_a_wrong_band_width():
    with pytest.raises(ValueError):
        t_sb2st_planar.bulge_chase_planar(torch.zeros((8, 5)), torch.zeros((8, 5)), 2)
    with pytest.raises(ValueError):
        t_sb2st_planar.bulge_chase_planar(torch.zeros((8, 4)), torch.zeros((9, 4)), 2)


@pytest.mark.parametrize("n,b", CHASE_CASES)
def test_phase_normalize_matches_jax(n, b):
    """Unit phases and |e| against the JAX log-depth scan (a sequential
    product here: 1e-13, the two orders of n unit-modulus products)."""
    _, _, (d, e, _, _) = _jax_chase(n, b)
    (p_r, p_i), mag = t_sb2st_planar.phase_normalize(torch.tensor(e[0]), torch.tensor(e[1]))
    (jp_r, jp_i), jmag = j_sb2st_planar.phase_normalize(jnp.asarray(e[0]), jnp.asarray(e[1]))
    assert _err(p_r, jp_r) < 1e-13 and _err(p_i, jp_i) < 1e-13 and _err(mag, jmag) == 0.0
    ph = p_r.numpy() + 1j * p_i.numpy()
    assert np.abs(np.abs(ph) - 1.0).max() < 1e-14 and ph[0] == 1.0
    # D^H T D is real: conj(p_{j+1}) e_j p_j = |e_j|
    ec = e[0] + 1j * e[1]
    assert np.abs(ph[1:].conj() * ec * ph[:-1] - mag.numpy()).max() < 1e-13 * np.abs(ec).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_phase_normalize_carries_a_zero_subdiagonal_entry(dtype):
    """|e_j| = 0 decouples the blocks: p_{j+1} = p_j, |e_j| = 0, and the
    phases stay on the unit circle (renormalised in fp32 too)."""
    rng = np.random.default_rng(5)
    e = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    e[[0, 17, 18, 39]] = 0.0
    e_r, e_i = torch.tensor(e.real, dtype=dtype), torch.tensor(e.imag, dtype=dtype)
    (p_r, p_i), mag = t_sb2st_planar.phase_normalize(e_r, e_i)
    (jp_r, jp_i), jmag = j_sb2st_planar.phase_normalize(jnp.asarray(e_r.numpy()),
                                                        jnp.asarray(e_i.numpy()))
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert _err(p_r, jp_r) < tol and _err(p_i, jp_i) < tol
    # |e|: one sqrt of a two-term sum, the same bits in fp64, one ulp in fp32
    assert _err(mag, jmag) <= (0.0 if dtype == torch.float64 else 2.4e-7)
    ph = p_r.numpy().astype(np.float64) + 1j * p_i.numpy().astype(np.float64)
    assert ph.shape == (41,) and ph[1] == ph[0] == 1.0
    assert ph[18] == ph[17] == ph[19] and ph[40] == ph[39]
    assert np.abs(np.abs(ph) - 1.0).max() < (1e-14 if dtype == torch.float64 else 2e-7)
    assert float(mag[17]) == 0.0 and mag.dtype == dtype


@pytest.mark.parametrize("gmul", [1, 3], ids=["g=b", "g=3b"])
@pytest.mark.parametrize("n,b", CHASE_CASES[1:])
def test_apply_q2_planar_matches_jax(n, b, gmul):
    """The JAX reflector store, carried over, replayed by the port; the
    result also diagonalises the band matrix with D from phase_normalize."""
    a, _, (d, e, vt, taut) = _jax_chase(n, b)
    g = gmul * b
    td, te, tvt, ttaut = planar_chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
    (p_r, p_i), mag = t_sb2st_planar.phase_normalize(*te)
    w, z = np.linalg.eigh(np.diag(d) + np.diag(mag.numpy(), 1) + np.diag(mag.numpy(), -1))
    y = (z * p_r.numpy()[:, None], z * p_i.numpy()[:, None])
    got = t_sb2st_planar.apply_q2_planar(tvt, ttaut, (torch.tensor(y[0]), torch.tensor(y[1])),
                                         n, b, g=g)
    want = j_sb2st_planar.apply_q2_planar(vt, taut, y, n, b, g=g)
    assert _err(got[0], want[0]) < TOL64 and _err(got[1], want[1]) < TOL64
    q2dz = got[0].numpy() + 1j * got[1].numpy()
    assert np.abs(a @ q2dz - q2dz * w[None, :]).max() < 1e-11 * n
    assert np.abs(q2dz.conj().T @ q2dz - np.eye(n)).max() < 1e-11 * n


@pytest.mark.parametrize("b,gs", [(4, (1, 3, 9, 16)), (8, (5, 17, 32))])
def test_apply_q2_planar_any_g_equals_the_scalar_replay(b, gs):
    """Every g, no multiple of anything, against the reflectors applied one
    by one in reverse chase order (the JAX test's oracle)."""
    n = 12 * b
    a = _herm(n, 212, b)
    band = [t_sb2st.dense_to_band(torch.tensor(x.copy()), b) for x in (a.real, a.imag)]
    d, e, vt, taut = t_sb2st_planar.bulge_chase_planar(*band, b)
    rng = np.random.default_rng(7)
    y = rng.standard_normal((n, 6)) + 1j * rng.standard_normal((n, 6))
    ref = y.copy()
    vc = vt[0].numpy() + 1j * vt[1].numpy()
    tc = taut[0].numpy() + 1j * taut[1].numpy()
    for t in range(vc.shape[0] - 1, -1, -1):
        for s in range(vc.shape[1]):
            if tc[t, s] == 0:
                continue
            r0 = t // 3 - s + 1 + (t % 3 + 3 * s) * b
            rows = slice(r0, min(r0 + b, n))
            vv = vc[t, s][: rows.stop - rows.start]
            ref[rows] -= tc[t, s] * np.outer(vv, vv.conj() @ ref[rows])
    for g in gs:
        zr, zi = t_sb2st_planar.apply_q2_planar(vt, taut, _planes(y), n, b, g=g)
        np.testing.assert_allclose(zr.numpy() + 1j * zi.numpy(), ref, rtol=0, atol=1e-12 * n,
                                   err_msg=f"b={b} g={g}")


@pytest.mark.parametrize("n,b,g", [(128, 8, 24), (96, 8, 8), (120, 8, 16)])
def test_window_qs_planar_is_unitary_and_matches_jax(n, b, g):
    """fp32, the kernel's working type: the JAX [Q_r | Q_i] blocks are the
    two planes side by side; every window unitary (identity tail and
    invalid slots included), equal to JAX's to fp32 round-off (1e-5)."""
    a = _herm(n, 213, b).astype(np.complex64)
    band = [j_sb2st.dense_to_band(jnp.asarray(x.copy(), jnp.float32), b) for x in (a.real, a.imag)]
    d, e, vt, taut = j_sb2st_planar.bulge_chase_planar(*band, b)
    want = np.asarray(jax_window_qs_planar(vt, taut, n, b, g))
    _, _, tvt, ttaut = planar_chase_from_numpy(np.asarray(d), _pair(e), _pair(vt), _pair(taut),
                                               n, b, device="cpu")
    qw = t_replay.window_qs_planar(tvt, ttaut, n, b, g)
    assert qw.dtype == torch.float32 and qw.is_contiguous()
    assert qw.shape == (2,) + want.shape[:2] + (128, 128)
    assert _err(torch.cat([qw[0], qw[1]], dim=-1), want) < 1e-5
    q = (qw[0].numpy().astype(np.float64) + 1j * qw[1].numpy()).reshape(-1, 128, 128)
    assert np.abs(np.einsum("uij,uik->ujk", q.conj(), q) - np.eye(128)).max() < 1e-4
    geo = t_replay._geometry(n, b, g)
    valid, _ = t_replay._wave_gather(geo, n, b, g, geo["n_groups"] * g + g, geo["kmax"] + 2)
    idle = q.reshape(valid.shape + (128, 128))[~valid]
    assert len(idle) > 0 and np.array_equal(idle, np.broadcast_to(np.eye(128), idle.shape))


def test_window_qs_planar_rejects_windows_past_128_rows():
    vt = (torch.zeros((3, 1, 8)), torch.zeros((3, 1, 8)))
    taut = (torch.zeros((3, 1)), torch.zeros((3, 1)))
    with pytest.raises(ValueError, match="l_win"):
        t_replay.window_qs_planar(vt, taut, 24, 8, 128)


def test_planar_two_stage_end_to_end():
    """dense Hermitian -> band -> complex tridiagonal -> real tridiagonal ->
    eigenvectors through Q1 Q2 D, all in the port."""
    n, b = 96, 8
    a = _herm(n, 214)
    (abr, abi), vs, ts = t_sbrd_planar.psbrd(*_planes(a), band=b)
    band = (t_sb2st.dense_to_band(abr, b), t_sb2st.dense_to_band(abi, b))
    d, e, vt, taut = t_sb2st_planar.bulge_chase_planar(*band, b)
    (p_r, p_i), mag = t_sb2st_planar.phase_normalize(*e)
    w, z = np.linalg.eigh(np.diag(d.numpy()) + np.diag(mag.numpy(), 1) + np.diag(mag.numpy(), -1))
    z = torch.tensor(z)
    y = t_sb2st_planar.apply_q2_planar(vt, taut, (z * p_r[:, None], z * p_i[:, None]), n, b,
                                       g=3 * b)
    zr, zi = t_sbrd_planar.apply_q1_planar(vs, ts, y)
    zc = zr.numpy() + 1j * zi.numpy()
    assert np.allclose(w, np.linalg.eigvalsh(a), atol=1e-11 * n)
    assert np.abs(a @ zc - zc * w[None, :]).max() < 1e-11 * n
    assert np.abs(zc.conj().T @ zc - np.eye(n)).max() < 1e-11 * n


def test_psbrd_of_a_banded_matrix_is_a_diagonal_unitary():
    """Every QL column has a zero tail, so each reflector is at most a pivot
    phase (zlarfg rotates a complex pivot to a real beta under a zero tail):
    |ab| = |a| entrywise and Q1 is diagonal."""
    n, b = 96, 8
    a = _herm(n, 215, b)
    (abr, abi), vs, ts = t_sbrd_planar.psbrd(*_planes(a), band=b)
    ab = abr.numpy() + 1j * abi.numpy()
    np.testing.assert_allclose(np.abs(ab), np.abs(a), rtol=0, atol=1e-12 * n)
    eye = (torch.eye(n, dtype=torch.float64), torch.zeros((n, n), dtype=torch.float64))
    q1r, q1i = t_sbrd_planar.apply_q1_planar(vs, ts, eye)
    q1 = q1r.numpy() + 1j * q1i.numpy()
    assert np.abs(q1 - np.diag(np.diag(q1))).max() < 1e-12 * n
    assert np.abs(q1 @ ab @ q1.conj().T - a).max() < 1e-11 * n


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_a_planar_reflector_store_crosses_between_the_packages(producer):
    """A store made by one package replays through the other's
    apply_q2_planar and apply_q1_planar (utils/convert carriers)."""
    n, b = 96, 8
    a = _herm(n, 216)
    if producer == "jax":
        ab, vs, ts = (_pair(x) for x in j_sbrd_planar.psbrd(a.real.copy(), a.imag.copy(), band=b))
        band = [j_sb2st.dense_to_band(jnp.asarray(x), b) for x in ab]
        d, e, vt, taut = j_sb2st_planar.bulge_chase_planar(*band, b)
        d, e, vt, taut = np.asarray(d), _pair(e), _pair(vt), _pair(taut)
    else:
        ab, vs, ts = t_sbrd_planar.psbrd(*_planes(a), band=b)
        band = [t_sb2st.dense_to_band(x, b) for x in ab]
        d, e, vt, taut = t_sb2st_planar.bulge_chase_planar(*band, b)
        num = lambda p: (p[0].numpy(), p[1].numpy())
        d, e, vt, taut, vs, ts = d.numpy(), num(e), num(vt), num(taut), num(vs), num(ts)
    mag = np.hypot(*e)
    w, z = np.linalg.eigh(np.diag(d) + np.diag(mag, 1) + np.diag(mag, -1))
    if producer == "jax":
        (p_r, p_i), _ = t_sb2st_planar.phase_normalize(torch.tensor(e[0]), torch.tensor(e[1]))
        _, _, tvt, ttaut = planar_chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
        _, tvs, tts = psbrd_from_numpy(ab, vs, ts, b, device="cpu")
        assert tvt[1].is_contiguous() and tvs[1].dtype == torch.float64
        zt = torch.tensor(z)
        y = t_sb2st_planar.apply_q2_planar(tvt, ttaut, (zt * p_r[:, None], zt * p_i[:, None]),
                                           n, b)
        zr, zi = (x.numpy() for x in t_sbrd_planar.apply_q1_planar(tvs, tts, y))
    else:
        (p_r, p_i), _ = j_sb2st_planar.phase_normalize(jnp.asarray(e[0]), jnp.asarray(e[1]))
        y0 = (z * np.asarray(p_r)[:, None], z * np.asarray(p_i)[:, None])
        y = j_sb2st_planar.apply_q2_planar(vt, taut, y0, n, b)
        zr, zi = (np.asarray(x) for x in j_sbrd_planar.apply_q1_planar(vs, ts, y))
    zc = zr + 1j * zi
    assert np.abs(a @ zc - zc * w[None, :]).max() < 1e-11 * n


def test_planar_carriers_check_the_layout():
    z = np.zeros
    with pytest.raises(ValueError):
        planar_band_from_numpy(z((10, 4)), z((10, 5)), 2, device="cpu")
    with pytest.raises(ValueError):
        planar_band_from_numpy(z((10, 4)), z((9, 4)), 2, device="cpu")
    with pytest.raises(ValueError):
        planar_chase_from_numpy(z(10), (z(9), z(9)), (z((24, 1, 2)), z((24, 2, 2))),
                                (z((24, 1)), z((24, 1))), 10, 2, device="cpu")
    with pytest.raises(ValueError):
        psbrd_from_numpy((z((64, 64)),) * 2, (z((3, 64, 16)), z((2, 64, 16))),
                         (z((3, 16, 16)),) * 2, 16, device="cpu")
    band = planar_band_from_numpy(np.ones((10, 4), dtype=np.float32), z((10, 4)), 2,
                                  device="cpu", dtype=torch.float64)
    assert band[1].dtype == torch.float64 and band[0].is_contiguous()


def _count_k1_calls(monkeypatch):
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return pchol_block_planar(*args, **kwargs)

    monkeypatch.setattr(t_planar, "pchol_block_planar", counted)
    return calls


@pytest.mark.parametrize("block_kernel", [True, False])
def test_pcholesky_block_kernel_selects_the_block_route(monkeypatch, block_kernel):
    """fp32: block_kernel=True sends every diagonal block to the K1 wrapper,
    False takes the plain _pchol_base + _fsub_base route, the JAX meaning of
    the argument. Both give the JAX factor to fp32 accuracy (1e-5 relative:
    sums in another order), and the same info."""
    n, nb = 256, 64
    _, b = random_hpd_pair(n, seed=217)
    br, bi = b.real.astype(np.float32), b.imag.astype(np.float32)
    calls = _count_k1_calls(monkeypatch)
    before = pchol_block_planar.launches
    (lr, li), info = t_planar.pcholesky_lower((torch.tensor(br), torch.tensor(bi)), nb=nb,
                                              block_kernel=block_kernel)
    assert len(calls) == (n // nb if block_kernel else 0)
    assert pchol_block_planar.launches == before  # a launch is counted on the card only
    (jlr, jli), jinfo = jax_pchol((jnp.asarray(br), jnp.asarray(bi)), nb=nb,
                                  block_kernel=block_kernel)
    assert int(info) == int(jinfo) == 0
    scale = np.abs(np.asarray(jlr)).max()
    assert _err(lr, jlr) < 1e-5 * scale and _err(li, jli) < 1e-5 * scale
    l = lr.numpy().astype(np.float64) + 1j * li.numpy()
    assert np.abs(l @ l.conj().T - b).max() < 1e-5 * np.abs(b).max()


def test_pcholesky_block_kernel_false_reports_a_bad_pivot_like_jax():
    n, nb = 128, 64
    _, b = random_hpd_pair(n, seed=218)
    b[70, 70] = -3.0
    br, bi = b.real.astype(np.float32), b.imag.astype(np.float32)
    _, info = t_planar.pcholesky_lower((torch.tensor(br), torch.tensor(bi)), nb=nb,
                                       block_kernel=False)
    _, jinfo = jax_pchol((jnp.asarray(br), jnp.asarray(bi)), nb=nb, block_kernel=False)
    assert int(info) == int(jinfo) == 71


@pytest.mark.parametrize("mosaic_kernels", [True, False])
def test_mosaic_kernels_reaches_the_cholesky_through_zhegvdx_planar(monkeypatch, mosaic_kernels):
    """zhegvdx_planar hands cfg.mosaic_kernels to pcholesky_lower: with False
    the fp32 Cholesky never enters the K1 wrapper."""
    n = 128
    a, b = random_hpd_pair(n, seed=219)
    calls = _count_k1_calls(monkeypatch)
    before = pchol_block_planar.launches
    cfg = SolverConfig(compute_dtype="float32", mosaic_kernels=mosaic_kernels)
    res = zhegvdx_planar_host(a, b, il=1, iu=8, cfg=cfg, device="cpu")
    assert int(res.info) == 0
    assert len(calls) == (1 if mosaic_kernels else 0)  # nb_chol = min(128, n)
    assert pchol_block_planar.launches == before
    import scipy.linalg

    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)[:8]
    assert np.abs(res.w.numpy() - w_ref).max() < 1e-10 * n
