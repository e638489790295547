"""The plain PyTorch versions of kernels K5, K7 and K9
(eigensolver_gpu_torch/ops/ql_panel.py, ops/chase.py, ops/replay.py)
against the Pallas kernels they stand in for, run in interpret mode as the
JAX package's own tests run them on the CPU; and the wrappers' dispatch.

On a CPU tensor a wrapper takes its kernel's plain version, so these
tests hold the arithmetic that the CUDA kernels repeat; the kernels
themselves are held to the plain versions on the card (chip_smoke.py,
tests/test_torch_card.py). fp32 throughout: the Pallas kernels are
fp32-only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigensolver_gpu_torch as eig
from eigensolver_gpu_tpu.ops.chase_pallas import bulge_chase_pallas
from eigensolver_gpu_tpu.ops.ql_panel_pallas import ql_panel_pallas
from eigensolver_gpu_tpu.ops.replay_pallas import apply_q2_pallas
from eigensolver_gpu_torch.ops import chase as t_chase
from eigensolver_gpu_torch.ops import ql_panel as t_ql
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.ops import sbrd as t_sbrd
from test_torch_real_helpers import make_pair

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _band32(n, b, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)).astype(np.float32)
    a = (t + t.T) / 2
    a = a * (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= b)
    return a, t_sb2st.dense_to_band(torch.from_numpy(a), b)


@pytest.mark.parametrize("m,b,rb", [(256, 32, 96), (512, 32, 448), (256, 32, 0), (128, 16, 32)])
def test_ql_panel_plain_matches_pallas_interpret(m, b, rb):
    """K5: (r_panel, v, tau, t) within 1e-5 (fp32 sums in another order)."""
    p = np.random.default_rng(0).standard_normal((m, b)).astype(np.float32)
    want = ql_panel_pallas(jnp.asarray(p), rb, interpret=True)
    got = t_ql.ql_panel(torch.from_numpy(p), rb)  # CPU tensor: the plain version
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) < 1e-5


def test_ql_panel_trivial_column():
    """A column already zero above its pivot: tau = 0, v = 0 with the pivot
    entry, the column left as it was -- in the plain version and in Pallas."""
    m, b, rb = 128, 16, 64
    p = np.random.default_rng(2).standard_normal((m, b)).astype(np.float32)
    p[: rb + b - 1, b - 1] = 0.0
    r1, v1, tau1, t1 = ql_panel_pallas(jnp.asarray(p), rb, interpret=True)
    r0, v0, tau0, t0 = t_ql.ql_panel_plain(torch.from_numpy(p), rb)
    assert float(tau0[b - 1]) == 0.0 == float(tau1[b - 1])
    assert float(v0[:, b - 1].abs().max()) == 0.0
    assert torch.equal(r0[:, b - 1], torch.from_numpy(p[:, b - 1]))
    for g, w in ((r0, r1), (v0, v1), (t0, t1)):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) < 1e-5


def test_ql_panel_takes_a_strided_column_slice_and_any_shape():
    """The caller's panel is a column slice of a row-major matrix; m and b
    need no alignment (the Pallas m % 128 and b % 8 rules are not carried)."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((100, 40)))
    panel = a[:90, 17:23]
    assert not panel.is_contiguous()
    r, v, tau, t = t_ql.ql_panel(panel, 50)
    r2, v2, tau2 = t_sbrd._ql_panel(panel.contiguous(), 50)
    assert torch.equal(r, r2) and torch.equal(v, v2) and torch.equal(tau, tau2)
    # H(0) .. H(b-1) = I - V T V^T zeroes the panel above its pivots
    q = torch.eye(90, dtype=torch.float64) - v @ t @ v.T
    assert float((q @ panel - r).abs().max()) < 1e-12
    assert float((q.T @ q - torch.eye(90, dtype=torch.float64)).abs().max()) < 1e-13
    # QL: zero above the pivots, which sit on the diagonal of rows [50, 56)
    assert float(r[:50].abs().max()) == 0.0 and float(torch.triu(r[50:56], 1).abs().max()) == 0.0
    assert float(torch.diagonal(r[50:56]).abs().min()) > 0 and torch.equal(r[56:], panel[56:])


@pytest.mark.parametrize("m,b,rb", [(64, 0, 0), (64, 65, 0), (64, 8, 57), (64, 8, -1)])
def test_ql_panel_rejects_bad_shapes(m, b, rb):
    with pytest.raises(ValueError):
        t_ql.ql_panel(torch.zeros((m, b)), rb)


@pytest.mark.parametrize("n,b", [(24, 4), (40, 8), (96, 16)])
def test_bulge_chase_plain_matches_pallas_interpret(n, b):
    """K7: the first t3 timesteps of the Pallas store are the plain
    version's; d, |e| and tau within the fp32 drift of two summation orders
    along the dependent steps (the JAX package's own tolerance)."""
    a, band = _band32(n, b, 0)
    d1, e1, vt1, tau1 = bulge_chase_pallas(jnp.asarray(band.numpy()), b, tb=6, interpret=True)
    d0, e0, vt0, tau0 = t_chase.bulge_chase_kernel(band, b)  # CPU tensor: the plain version
    t3 = vt0.shape[0]
    assert t3 == t_sb2st.chase_dims(n, b)[2] <= vt1.shape[0]
    np.testing.assert_allclose(d0.numpy(), np.asarray(d1), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.abs(e0.numpy()), np.abs(np.asarray(e1)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tau0.numpy(), np.asarray(tau1)[:t3], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(tau1)[t3:], 0.0)
    w = np.linalg.eigvalsh(np.diag(d0.numpy()) + np.diag(e0.numpy(), 1) + np.diag(e0.numpy(), -1))
    assert np.abs(w - np.linalg.eigvalsh(a)).max() < 1e-4 * np.abs(a).max() * np.sqrt(n)


@pytest.mark.parametrize("n,b,bad", [(2, 2, "n"), (16, 1, "b"), (300, 65, "b")])
def test_bulge_chase_kernel_rejects_bad_shapes(n, b, bad):
    with pytest.raises(ValueError):
        t_chase.bulge_chase_kernel(torch.zeros((n, 2 * b)), b)
    with pytest.raises(ValueError):
        t_chase.bulge_chase_kernel(torch.zeros((max(n, 3), 2 * b + 1)), b)


@pytest.mark.parametrize("n,b,g,m", [
    (96, 8, 8, 40),
    (128, 8, 24, 40),
    (256, 16, 48, 40),
    (120, 8, 16, 40),
    (96, 8, 24, 23),  # a column count that divides no tile
])
def test_apply_q2_plain_matches_pallas_interpret(n, b, g, m):
    """K9: within 1e-5 relative of the Pallas replay, and of the port's own
    scalar-order (g = 1) replay."""
    a, band = _band32(n, b, 7)
    d, e, vt, taut = t_sb2st.bulge_chase(band, b)
    y = np.random.default_rng(7).standard_normal((n, m)).astype(np.float32)
    want = apply_q2_pallas(jnp.asarray(vt.numpy()), jnp.asarray(taut.numpy()), jnp.asarray(y),
                           n, b, g=g, m_tile=16, interpret=True)
    got = t_replay.apply_q2_kernel(vt, taut, torch.from_numpy(y), n, b, g=g)  # CPU: plain
    assert got.shape == (n, m) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    z1 = t_sb2st.apply_q2(vt, taut, torch.from_numpy(y), n, b, g=1)
    assert _rel(got.numpy(), z1.numpy()) < 1e-5


def test_apply_q2_kernel_takes_any_g_and_b_up_to_128_rows():
    """g and b need no multiple of 8 (a Pallas tiling rule); l_win > 128
    raises, naming it, as in JAX."""
    n, b = 50, 6
    a, band = _band32(n, b, 8)
    d, e, vt, taut = t_sb2st.bulge_chase(band.double(), b)
    y = torch.from_numpy(np.random.default_rng(8).standard_normal((n, 5)))
    z1 = t_sb2st.apply_q2(vt, taut, y, n, b, g=1)
    for g in (5, 7, 3 * b, 123):
        z = t_replay.apply_q2_kernel(vt, taut, y, n, b, g=g)
        assert float((z - z1).abs().max()) < 1e-12
    assert t_replay.apply_q2_kernel(vt, taut, y, n, b).shape == (n, 5)  # g defaults to 3b
    with pytest.raises(ValueError, match="l_win"):
        t_replay.apply_q2_kernel(vt, taut, y, n, b, g=124)
    with pytest.raises(ValueError):
        t_replay.apply_q2_kernel(vt, taut, y[:-1], n, b, g=6)
    with pytest.raises(ValueError):
        t_replay.apply_q2_kernel(vt, taut, y.float(), n, b, g=6)


def test_geometry_matches_the_jax_schedule():
    from eigensolver_gpu_tpu.ops.replay_pallas import _geometry as jax_geometry

    for n, b, g in [(4096, 32, 96), (128, 8, 24), (100, 6, 5), (40, 8, 120), (3, 2, 2)]:
        geo, want = t_replay._geometry(n, b, g), jax_geometry(n, b, g)
        for key, val in want.items():
            assert np.array_equal(geo[key], val), (n, b, g, key)
        assert geo["n_slots"] % 4 == 0 and 0 <= geo["n_slots"] - geo["n_act"] < 4
    geo = t_replay._geometry(4096, 32, 96)
    assert (geo["n_waves"], geo["n_slots"], geo["l_win"]) == (212, 28, 127)


def _count_calls(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("mosaic_kernels", [True, False])
def test_two_stage_dispatch_on_cpu_tensors(monkeypatch, mosaic_kernels):
    """mosaic_kernels=True sends the panel, the chase and the replay through
    their wrappers, which on CPU tensors call the plain versions and count no
    launch; False never enters a wrapper."""
    wrappers, plains = {}, {}
    _count_calls(monkeypatch, t_ql, "ql_panel", wrappers)
    _count_calls(monkeypatch, t_chase, "bulge_chase_kernel", wrappers)
    _count_calls(monkeypatch, t_replay, "apply_q2_kernel", wrappers)
    _count_calls(monkeypatch, t_ql, "ql_panel_plain", plains)
    _count_calls(monkeypatch, t_chase, "bulge_chase", plains)
    _count_calls(monkeypatch, t_replay, "apply_q2", plains)
    n = 128
    a, b = make_pair(n, np.float64)
    cfg = eig.SolverConfig(tridiag_mode="two", mosaic_kernels=mosaic_kernels)
    res = eig.dsygvdx(a, b, il=1, iu=8, cfg=cfg, device="cpu")
    assert int(res.info) == 0
    if mosaic_kernels:
        panels = n // cfg.band - 1
        assert wrappers == {"ql_panel": panels, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
        assert plains == {"ql_panel_plain": panels, "bulge_chase": 1, "apply_q2": 1}
    else:
        assert wrappers == {} and plains == {}
    for fn in (t_ql.ql_panel, t_chase.bulge_chase_kernel, t_replay.apply_q2_kernel):
        assert getattr(fn, "launches", 0) == 0  # a launch is counted on the card only


def test_both_routes_give_the_same_solution():
    a, b = make_pair(128, np.float64)
    on = eig.dsygvdx(a, b, il=1, iu=8, cfg=eig.SolverConfig(tridiag_mode="two"), device="cpu")
    off = eig.dsygvdx(a, b, il=1, iu=8, device="cpu",
                      cfg=eig.SolverConfig(tridiag_mode="two", mosaic_kernels=False))
    assert torch.equal(on.w, off.w) and torch.equal(on.z, off.z)
