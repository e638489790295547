"""The plain PyTorch versions of kernels K6, K8 and K10
(eigensolver_gpu_torch/ops/ql_panel.py, ops/chase.py, ops/replay.py: the
planar functions) against the Pallas kernels they stand in for, run in
interpret mode as the JAX package's own tests run them on the CPU; and the
wrappers' checks and dispatch.

On a CPU tensor a wrapper takes its kernel's plain version, so these tests
hold the arithmetic that the CUDA kernels repeat; the kernels themselves
are held to the plain versions on the card (chip_smoke.py,
tests/test_torch_card.py). fp32 throughout: the Pallas kernels are
fp32-only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigensolver_gpu_torch as eig
from eigensolver_gpu_tpu.ops.chase_pallas import bulge_chase_planar_pallas
from eigensolver_gpu_tpu.ops.ql_panel_pallas import ql_panel_planar_pallas
from eigensolver_gpu_tpu.ops.replay_pallas import apply_q2_planar_pallas
from eigensolver_gpu_torch.ops import chase as t_chase
from eigensolver_gpu_torch.ops import ql_panel as t_ql
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.ops import sb2st_planar as t_sb2st_planar
from eigensolver_gpu_torch.ops import sbrd_planar as t_sbrd_planar
from eigensolver_gpu_torch.utils.testing import random_hpd_pair

torch.set_num_threads(2)

QL_NAMES = ("pf_r", "pf_i", "v_r", "v_i", "tau_r", "tau_i", "t_r", "t_i")


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _hband32(n, b, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (t + t.conj().T) / 2
    a = (a * (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= b)).astype(np.complex64)
    planes = tuple(t_sb2st.dense_to_band(torch.from_numpy(np.ascontiguousarray(x)), b)
                   for x in (a.real, a.imag))
    return a, planes


@pytest.mark.parametrize("m,b,rb", [(256, 32, 96), (512, 32, 448), (256, 32, 0), (128, 8, 24)])
def test_ql_panel_planar_plain_matches_pallas_interpret(m, b, rb):
    """K6: all eight outputs within 1e-5 (at most 32 dependent columns, fp32
    sums in another order)."""
    rng = np.random.default_rng(1)
    pr = rng.standard_normal((m, b)).astype(np.float32)
    pi = rng.standard_normal((m, b)).astype(np.float32)
    want = ql_panel_planar_pallas(jnp.asarray(pr), jnp.asarray(pi), rb, interpret=True)
    got = t_ql.ql_panel_planar(torch.from_numpy(pr), torch.from_numpy(pi), rb)  # CPU: plain
    assert len(got) == len(want) == 8
    for name, g, w in zip(QL_NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) < 1e-5, name


def test_ql_panel_planar_trivial_and_phase_only_columns():
    """Trivial needs a zero tail AND a real pivot: tau = 0, v = 0 with the
    pivot entry, the column left as it was. A zero tail under a complex
    pivot is a reflector still: tau != 0, v = e_top, the pivot rotated to
    the real beta = -sign(Re alpha) |alpha|. In the plain version and in
    Pallas."""
    m, b, rb = 128, 16, 64
    rng = np.random.default_rng(2)
    pr = rng.standard_normal((m, b)).astype(np.float32)
    pi = rng.standard_normal((m, b)).astype(np.float32)
    pr[: rb + b - 1, b - 1] = 0.0  # column b-1: trivial
    pi[: rb + b, b - 1] = 0.0
    pr[: rb + b - 2, b - 2] = 0.0  # column b-2: phase only
    pi[: rb + b - 2, b - 2] = 0.0
    want = ql_panel_planar_pallas(jnp.asarray(pr), jnp.asarray(pi), rb, interpret=True)
    got = t_ql.ql_panel_planar_plain(torch.from_numpy(pr), torch.from_numpy(pi), rb)
    pf_r, pf_i, v_r, v_i, tau_r, tau_i, _, _ = got
    for tau in (tau_r, tau_i, want[4], want[5]):
        assert float(tau[b - 1]) == 0.0
    assert float(v_r[:, b - 1].abs().max()) == 0.0 == float(v_i[:, b - 1].abs().max())
    assert torch.equal(pf_r[:, b - 1], torch.from_numpy(pr[:, b - 1]))
    top = rb + b - 2
    alpha = complex(pr[top, b - 2], pi[top, b - 2])
    assert float(tau_i[b - 2]) != 0.0 and float(v_r[top, b - 2]) == 1.0
    assert float(v_r[:top, b - 2].abs().max()) == 0.0 == float(v_i[:, b - 2].abs().max())
    assert abs(float(pf_r[top, b - 2]) + np.sign(alpha.real) * abs(alpha)) < 1e-6 * abs(alpha)
    # every pivot is real: the imaginary plane is zero on and above it
    for j in range(b):
        assert float(pf_i[: rb + j + 1, j].abs().max()) == 0.0
    for name, g, w in zip(QL_NAMES, got, want):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) < 1e-5, name


def test_ql_panel_planar_takes_strided_column_slices_and_any_shape():
    """The caller's panel is a pair of column slices of row-major planes; m
    and b need no alignment. N = I - V T V^H (T from the conjugated taus) is
    unitary and takes the panel to its factor."""
    rng = np.random.default_rng(3)
    ar, ai = (torch.from_numpy(rng.standard_normal((100, 40))) for _ in range(2))
    pan_r, pan_i = ar[:90, 17:23], ai[:90, 17:23]
    assert not pan_r.is_contiguous()
    out = t_ql.ql_panel_planar(pan_r, pan_i, 50)
    ref = t_sbrd_planar._ql_panel_planar(pan_r.contiguous(), pan_i.contiguous(), 50)
    assert all(torch.equal(x, y) for x, y in zip(out[:6], ref))
    pf, v, t = (torch.complex(out[k], out[k + 1]) for k in (0, 2, 6))
    eye = torch.eye(90, dtype=torch.complex128)
    nmat = eye - v @ t @ v.conj().T
    assert float((nmat @ torch.complex(pan_r, pan_i) - pf).abs().max()) < 1e-12
    assert float((nmat.conj().T @ nmat - eye).abs().max()) < 1e-13
    # QL: zero above the pivots, which sit on the diagonal of rows [50, 56)
    assert float(pf[:50].abs().max()) == 0.0 and float(torch.triu(pf[50:56], 1).abs().max()) == 0.0
    assert float(torch.diagonal(pf[50:56]).abs().min()) > 0
    assert torch.equal(out[0][56:], pan_r[56:]) and torch.equal(out[1][56:], pan_i[56:])


@pytest.mark.parametrize("m,b,rb", [(64, 0, 0), (64, 65, 0), (64, 8, 57), (64, 8, -1)])
def test_ql_panel_planar_rejects_bad_shapes(m, b, rb):
    with pytest.raises(ValueError):
        t_ql.ql_panel_planar(torch.zeros((m, b)), torch.zeros((m, b)), rb)
    with pytest.raises(ValueError):
        t_ql.ql_panel_planar(torch.zeros((64, 8)), torch.zeros((64, 7)), 0)
    with pytest.raises(ValueError):
        t_ql.ql_panel_planar(torch.zeros((64, 8)), torch.zeros((64, 8), dtype=torch.float64), 0)


@pytest.mark.parametrize("n,b", [(40, 8), (96, 8), (96, 16)])
def test_bulge_chase_planar_plain_matches_pallas_interpret(n, b):
    """K8: the first t3 timesteps of the Pallas store are the plain
    version's layout. d, |e| and |tau| within the fp32 drift of two summation
    orders along about 3n dependent steps (the JAX package's own tolerance,
    2e-3; the phase of e is ill-conditioned and is not held), and the whole
    output through what it must satisfy: the spectrum of (d, |e|) is the band
    matrix's, and Q2 (D T D^H) Q2^H gives the band matrix back, both to
    1e-4 ||a|| sqrt(n)."""
    a, (band_r, band_i) = _hband32(n, b, 5)
    d1, (e1r, e1i), vt1, tt1 = bulge_chase_planar_pallas(
        jnp.asarray(band_r.numpy()), jnp.asarray(band_i.numpy()), b, tb=6, interpret=True)
    d0, e0, vt0, tt0 = t_chase.bulge_chase_planar_kernel(band_r, band_i, b)  # CPU: plain
    t3 = vt0[0].shape[0]
    assert t3 == t_sb2st.chase_dims(n, b)[2] <= vt1[0].shape[0]
    assert vt0[0].shape[1:] == vt1[0].shape[1:] and tt0[1].shape[1:] == tt1[1].shape[1:]
    np.testing.assert_allclose(d0.numpy(), np.asarray(d1), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.hypot(e0[0].numpy(), e0[1].numpy()),
                               np.hypot(np.asarray(e1r), np.asarray(e1i)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.hypot(tt0[0].numpy(), tt0[1].numpy()),
                               np.hypot(np.asarray(tt1[0]), np.asarray(tt1[1]))[:t3],
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(tt1[0])[t3:], 0.0)
    (p_r, p_i), mag = t_sb2st_planar.phase_normalize(*e0)
    tri = np.diag(d0.numpy().astype(np.float64)) + np.diag(mag.numpy().astype(np.float64), 1)
    tri = tri + np.diag(mag.numpy().astype(np.float64), -1)
    a64 = a.astype(np.complex128)
    tol = 1e-4 * np.abs(a).max() * np.sqrt(n)
    assert np.abs(np.linalg.eigvalsh(tri) - np.linalg.eigvalsh(a64)).max() < tol
    eye = (torch.eye(n), torch.zeros((n, n)))
    q2r, q2i = t_sb2st_planar.apply_q2_planar(vt0, tt0, eye, n, b)
    q2d = (q2r.numpy().astype(np.float64) + 1j * q2i.numpy()) * (
        p_r.numpy().astype(np.float64) + 1j * p_i.numpy())[None, :]
    assert np.abs(q2d @ tri @ q2d.conj().T - a64).max() < tol


@pytest.mark.parametrize("n,b,bad", [(2, 2, "n"), (16, 1, "b"), (300, 65, "b")])
def test_bulge_chase_planar_kernel_rejects_bad_shapes(n, b, bad):
    z = torch.zeros((n, 2 * b))
    with pytest.raises(ValueError):
        t_chase.bulge_chase_planar_kernel(z, z, b)
    z = torch.zeros((max(n, 3), 2 * b + 1))
    with pytest.raises(ValueError):
        t_chase.bulge_chase_planar_kernel(z, z, b)
    with pytest.raises(ValueError):
        t_chase.bulge_chase_planar_kernel(torch.zeros((8, 4)), torch.zeros((8, 4)).double(), 2)


@pytest.mark.parametrize("n,b,g,m", [
    (96, 8, 8, 40),
    (128, 8, 24, 40),
    (256, 16, 48, 40),
    (96, 8, 24, 23),  # a column count that divides no tile
])
def test_apply_q2_planar_plain_matches_pallas_interpret(n, b, g, m):
    """K10: both planes within 1e-5 relative of the Pallas replay (window
    sums of at most 63 terms in another order), and of the port's own
    scalar-order (g = 1) replay."""
    _, (band_r, band_i) = _hband32(n, b, 11)
    _, _, vt, taut = t_sb2st_planar.bulge_chase_planar(band_r, band_i, b)
    rng = np.random.default_rng(11)
    y = tuple(rng.standard_normal((n, m)).astype(np.float32) for _ in range(2))
    jpair = lambda p: (jnp.asarray(p[0].numpy()), jnp.asarray(p[1].numpy()))
    want = apply_q2_planar_pallas(jpair(vt), jpair(taut), (jnp.asarray(y[0]), jnp.asarray(y[1])),
                                  n, b, g=g, m_tile=16, interpret=True)
    ty = (torch.from_numpy(y[0]), torch.from_numpy(y[1]))
    got = t_replay.apply_q2_planar_kernel(vt, taut, ty, n, b, g=g)  # CPU: plain
    z1 = t_sb2st_planar.apply_q2_planar(vt, taut, ty, n, b, g=1)
    for plane in (0, 1):
        assert got[plane].shape == (n, m) and got[plane].dtype == torch.float32
        assert _rel(got[plane].numpy(), want[plane]) < 1e-5
        assert _rel(got[plane].numpy(), z1[plane].numpy()) < 1e-5


def test_apply_q2_planar_kernel_takes_any_g_and_b_up_to_128_rows():
    """g and b need no multiple of 8 (a Pallas tiling rule); l_win > 128
    raises, naming it, as in JAX."""
    n, b = 50, 6
    _, (band_r, band_i) = _hband32(n, b, 8)
    _, _, vt, taut = t_sb2st_planar.bulge_chase_planar(band_r.double(), band_i.double(), b)
    rng = np.random.default_rng(8)
    y = tuple(torch.from_numpy(rng.standard_normal((n, 5))) for _ in range(2))
    z1 = t_sb2st_planar.apply_q2_planar(vt, taut, y, n, b, g=1)
    for g in (5, 7, 3 * b, 123):
        z = t_replay.apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
        assert float((z[0] - z1[0]).abs().max()) < 1e-12
        assert float((z[1] - z1[1]).abs().max()) < 1e-12
    assert t_replay.apply_q2_planar_kernel(vt, taut, y, n, b)[1].shape == (n, 5)  # g = 3b
    with pytest.raises(ValueError, match="l_win"):
        t_replay.apply_q2_planar_kernel(vt, taut, y, n, b, g=124)
    with pytest.raises(ValueError):
        t_replay.apply_q2_planar_kernel(vt, taut, (y[0][:-1], y[1][:-1]), n, b, g=6)
    with pytest.raises(ValueError):
        t_replay.apply_q2_planar_kernel(vt, taut, (y[0], y[1].float()), n, b, g=6)


def _count_calls(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("mosaic_kernels", [True, False])
def test_planar_two_stage_dispatch_on_cpu_tensors(monkeypatch, mosaic_kernels):
    """mosaic_kernels=True sends the panel, the chase and the replay through
    their wrappers, which on CPU tensors call the plain versions and count no
    launch; False never enters a wrapper."""
    wrappers, plains = {}, {}
    kernels = (t_ql.ql_panel_planar, t_chase.bulge_chase_planar_kernel,
               t_replay.apply_q2_planar_kernel)
    _count_calls(monkeypatch, t_ql, "ql_panel_planar", wrappers)
    _count_calls(monkeypatch, t_chase, "bulge_chase_planar_kernel", wrappers)
    _count_calls(monkeypatch, t_replay, "apply_q2_planar_kernel", wrappers)
    _count_calls(monkeypatch, t_ql, "ql_panel_planar_plain", plains)
    _count_calls(monkeypatch, t_chase, "bulge_chase_planar", plains)
    _count_calls(monkeypatch, t_replay, "apply_q2_planar", plains)
    n = 128
    a, b = random_hpd_pair(n, seed=31)
    cfg = eig.SolverConfig(tridiag_mode="two", mosaic_kernels=mosaic_kernels)
    res = eig.zhegvdx_planar_host(a, b, il=1, iu=8, cfg=cfg, device="cpu")
    assert int(res.info) == 0
    if mosaic_kernels:
        panels = n // cfg.band - 1
        assert wrappers == {"ql_panel_planar": panels, "bulge_chase_planar_kernel": 1,
                            "apply_q2_planar_kernel": 1}
        assert plains == {"ql_panel_planar_plain": panels, "bulge_chase_planar": 1,
                          "apply_q2_planar": 1}
    else:
        assert wrappers == {} and plains == {}
    assert [fn.launches for fn in kernels] == [0, 0, 0]  # counted on the card only


@pytest.mark.parametrize("kw", [{}, dict(compute_dtype="float32")], ids=["fp64", "mp"])
def test_both_planar_routes_give_the_same_solution(kw):
    """On the CPU the wrappers take the plain versions, so mosaic_kernels
    True and False agree: bit for bit in fp64; in the mixed mode the fp32
    Cholesky takes another block route (inverted diagonal blocks against
    substitution), so the refined pairs agree to fp64 accuracy."""
    n = 128
    a, b = random_hpd_pair(n, seed=32)
    on = eig.zhegvdx_planar_host(a, b, il=1, iu=8, device="cpu",
                                 cfg=eig.SolverConfig(tridiag_mode="two", **kw))
    off = eig.zhegvdx_planar_host(a, b, il=1, iu=8, device="cpu", cfg=eig.SolverConfig(
        tridiag_mode="two", mosaic_kernels=False, **kw))
    if kw:
        assert float((on.w - off.w).abs().max()) < 1e-11 * n
    else:
        assert torch.equal(on.w, off.w) and torch.equal(on.zr, off.zr)
        assert torch.equal(on.zi, off.zi)
