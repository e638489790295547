"""The port's two-stage reduction (eigensolver_gpu_torch/ops/sbrd.py,
ops/sb2st.py, ops/replay.window_qs) stage by stage against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its torch twin. In fp64 the stage outputs are held elementwise to 1e-11;
in fp32 two correct reductions drift apart along their dependent steps,
so the fp32 cases hold what a reduction must satisfy (band structure,
``Q1 ab Q1^T = a``, the spectrum of ``(d, e)`` to 1e-4 ||a||).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu.ops.replay_pallas import window_qs as jax_window_qs
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.ops import sbrd as t_sbrd
from eigensolver_gpu_torch.utils.convert import (
    band_from_numpy,
    chase_from_numpy,
    sbrd_from_numpy,
)
from eigensolver_gpu_torch.utils.testing import random_spd_pair

# the JAX ops package re-exports functions under its modules' names
j_sb2st = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st")
j_sbrd = importlib.import_module("eigensolver_gpu_tpu.ops.sbrd")

torch.set_num_threads(2)

TOL64 = 1e-11
SBRD_CASES = [(128, 32, 512), (192, 32, 96), (256, 64, 128)]
CHASE_CASES = [(64, 4), (96, 8), (100, 6)]


def _err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


def _banded(n, b, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n))
    a = (t + t.T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    return a.astype(dtype)


@functools.lru_cache(maxsize=None)
def _jax_chase(n, b):
    a = _banded(n, b, 111)
    band = np.asarray(j_sb2st.dense_to_band(a, b))
    return a, band, tuple(np.asarray(x) for x in j_sb2st.bulge_chase(band, b))


@functools.lru_cache(maxsize=None)
def _jax_sbrd(n, b, bucket):
    a, _ = random_spd_pair(n, seed=110)
    return a, tuple(np.asarray(x) for x in j_sbrd.sbrd(a, band=b, bucket=bucket))


@pytest.mark.parametrize("n,b", [(64, 4), (100, 6), (80, 12)])
def test_dense_to_band_and_back(n, b):
    a = _banded(n, b, 5)
    band = t_sb2st.dense_to_band(torch.from_numpy(a), b)
    assert band.shape == (n, 2 * b)
    assert _err(band, j_sb2st.dense_to_band(a, b)) == 0.0
    assert _err(t_sb2st.band_to_dense(band, b), a) < 1e-14
    dense_j = j_sb2st.band_to_dense(jnp.asarray(band.numpy()), b)
    assert _err(t_sb2st.band_to_dense(band, b), dense_j) < 1e-14


@pytest.mark.parametrize("panel_kernel", [True, False], ids=["wrapper", "plain"])
@pytest.mark.parametrize("n,b,bucket", SBRD_CASES)
def test_sbrd_matches_jax(n, b, bucket, panel_kernel):
    """(ab, vs, ts) elementwise; on CPU tensors the panel wrapper takes its
    plain version, so both routes give the same factors."""
    a, want = _jax_sbrd(n, b, bucket)
    got = t_sbrd.sbrd(torch.from_numpy(a), band=b, bucket=bucket, panel_kernel=panel_kernel)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float64
        assert _err(g, w) < TOL64


@pytest.mark.parametrize("n,band", [(64, 48), (100, 32), (32, 16)])
def test_sbrd_rejects_what_jax_rejects(n, band):
    with pytest.raises(ValueError):
        t_sbrd.sbrd(torch.eye(n, dtype=torch.float64), band=band)
    with pytest.raises(ValueError):
        j_sbrd.sbrd(np.eye(n), band=band)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("n,b,bucket", SBRD_CASES[:2])
def test_apply_q1_matches_jax(n, b, bucket, group):
    _, (ab, vs, ts) = _jax_sbrd(n, b, bucket)
    y = np.random.default_rng(3).standard_normal((n, 9))
    tab, tvs, tts = sbrd_from_numpy(ab, vs, ts, b, device="cpu")
    got = t_sbrd.apply_q1(tvs, tts, torch.from_numpy(y), group=group)
    assert _err(got, j_sbrd.apply_q1(vs, ts, y, group=group)) < TOL64


@pytest.mark.parametrize("n,b", CHASE_CASES)
def test_bulge_chase_matches_jax(n, b):
    _, band, want = _jax_chase(n, b)
    got = t_sb2st.bulge_chase(band_from_numpy(band, b, device="cpu"), b)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _err(g, w) < TOL64


@pytest.mark.parametrize("n,b", CHASE_CASES)
def test_repack_sweep_major_matches_jax(n, b):
    _, _, (d, e, vt, taut) = _jax_chase(n, b)
    _, _, tvt, ttaut = chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
    got = t_sb2st.repack_sweep_major(tvt, ttaut, b, n)
    want = j_sb2st.repack_sweep_major(jnp.asarray(vt), jnp.asarray(taut), b, n)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert _err(g, w) == 0.0


@pytest.mark.parametrize("tsolve", ["qform", "inv", "solve"])
@pytest.mark.parametrize("g", [1, 5, 8, 16])
def test_apply_q2_matches_jax(g, tsolve):
    n, b = 96, 8
    a, _, (d, e, vt, taut) = _jax_chase(n, b)
    w, y = np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    _, _, tvt, ttaut = chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
    z = t_sb2st.apply_q2(tvt, ttaut, torch.from_numpy(y), n, b, g=g, tsolve=tsolve).numpy()
    assert _err(z, j_sb2st.apply_q2(vt, taut, y, n, b, g=g, tsolve=tsolve)) < TOL64
    assert np.abs(a @ z - z * w).max() < 1e-11 * n


@pytest.mark.parametrize("b,gs", [
    (4, (3, 4, 8, 9, 12, 16)),
    (8, (8, 16, 17, 24, 32)),
    (16, (16, 32, 33, 48, 64)),
])
def test_apply_q2_any_g_equals_the_scalar_replay(b, gs):
    """The wave schedule holds for every g, including g > 2b: the port's
    own chase and replay against its g = 1 replay and against JAX's."""
    n = 16 * b
    a = _banded(n, b, 7)
    band = t_sb2st.dense_to_band(torch.from_numpy(a), b)
    d, e, vt, taut = t_sb2st.bulge_chase(band, b)
    y = torch.from_numpy(np.random.default_rng(7).standard_normal((n, 8)))
    z1 = t_sb2st.apply_q2(vt, taut, y, n, b, g=1).numpy()
    zj = j_sb2st.apply_q2(jnp.asarray(vt.numpy()), jnp.asarray(taut.numpy()), y.numpy(), n, b, g=1)
    assert _err(z1, zj) < 1e-12
    for g in gs:
        z = t_sb2st.apply_q2(vt, taut, y, n, b, g=g).numpy()
        np.testing.assert_allclose(z, z1, rtol=0, atol=1e-12, err_msg=f"b={b} g={g}")


def test_apply_q2_rejects_an_unknown_tsolve():
    vt, taut = torch.zeros((3, 1, 2)), torch.zeros((3, 1))
    with pytest.raises(ValueError):
        t_sb2st.apply_q2(vt, taut, torch.zeros((3, 1)), 3, 2, tsolve="lu")
    with pytest.raises(ValueError):
        t_sb2st.bulge_chase(torch.zeros((8, 5)), 2)


@pytest.mark.parametrize("n,b,g", [(128, 8, 24), (96, 8, 8), (120, 8, 16)])
def test_window_qs_is_orthogonal_and_matches_jax(n, b, g):
    """fp32, the kernel's working type: JAX layout, every block orthogonal
    (identity tail included), equal to JAX's to fp32 round-off."""
    a = _banded(n, b, 9, np.float32)
    band = j_sb2st.dense_to_band(jnp.asarray(a), b)
    d, e, vt, taut = (np.asarray(x) for x in j_sb2st.bulge_chase(band, b))
    want = np.asarray(jax_window_qs(jnp.asarray(vt), jnp.asarray(taut), n, b, g))
    _, _, tvt, ttaut = chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
    got = t_replay.window_qs(tvt, ttaut, n, b, g).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _err(got, want) < 1e-5
    blocks = got.reshape(-1, 128, 128)
    eye = np.eye(128, dtype=np.float32)
    assert np.abs(np.einsum("uij,uik->ujk", blocks, blocks) - eye).max() < 1e-4


def test_window_qs_rejects_windows_past_128_rows():
    vt, taut = torch.zeros((3, 1, 8)), torch.zeros((3, 1))
    with pytest.raises(ValueError, match="l_win"):
        t_replay.window_qs(vt, taut, 24, 8, 128)


@pytest.mark.parametrize("n,b,bucket", SBRD_CASES)
def test_fp32_sbrd_band_structure_and_similarity(n, b, bucket):
    a, _ = random_spd_pair(n, seed=110)
    a32 = torch.tensor(a, dtype=torch.float32)
    ab, vs, ts = t_sbrd.sbrd(a32, band=b, bucket=bucket)
    assert ab.dtype == torch.float32
    scale = np.abs(a).max()
    outside = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b
    assert np.abs(ab.numpy()[outside]).max() < 1e-5 * scale
    q = t_sbrd.apply_q1(vs, ts, torch.eye(n, dtype=torch.float32)).numpy().astype(np.float64)
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-4
    assert np.abs(q @ ab.numpy().astype(np.float64) @ q.T - a).max() < 1e-4 * scale
    assert np.abs(np.linalg.eigvalsh(ab.numpy().astype(np.float64)) - np.linalg.eigvalsh(a)).max() \
        < 1e-4 * scale


@pytest.mark.parametrize("n,b", CHASE_CASES)
def test_fp32_chase_keeps_the_spectrum(n, b):
    """Not elementwise: fp32 reductions in another summation order drift
    apart; the spectrum of (d, e) is the band matrix's to 1e-4 ||a||."""
    a = _banded(n, b, 111)
    band = t_sb2st.dense_to_band(torch.tensor(a, dtype=torch.float32), b)
    d, e, vt, taut = t_sb2st.bulge_chase(band, b)
    assert d.dtype == torch.float32 and vt.dtype == torch.float32
    d, e = d.numpy().astype(np.float64), e.numpy().astype(np.float64)
    tri = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    w_ref = np.linalg.eigvalsh(a)
    assert np.abs(np.linalg.eigvalsh(tri) - w_ref).max() < 1e-4 * np.abs(a).max() * np.sqrt(n)
    # inactive slots carry tau = 0
    s_slots, t_total, t3 = t_sb2st.chase_dims(n, b)
    assert vt.shape == (t3, s_slots, b) and float(taut[t_total:].abs().max()) == 0.0


@pytest.mark.parametrize("n,b", [(128, 16), (192, 32)])
def test_two_stage_end_to_end(n, b):
    """dense -> band -> tridiagonal -> eigenvectors through Q1 Q2."""
    a, _ = random_spd_pair(n, seed=113)
    ab, vs, ts = t_sbrd.sbrd(torch.from_numpy(a), band=b)
    d, e, vt, taut = t_sb2st.bulge_chase(t_sb2st.dense_to_band(ab, b), b)
    d, e = d.numpy(), e.numpy()
    w, y = np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    z = t_sbrd.apply_q1(vs, ts, t_sb2st.apply_q2(vt, taut, torch.from_numpy(y), n, b)).numpy()
    assert np.allclose(w, np.linalg.eigvalsh(a), atol=1e-11 * n)
    assert np.abs(a @ z - z * w[None, :]).max() < 1e-11 * n
    assert np.abs(z.T @ z - np.eye(n)).max() < 1e-11 * n


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_a_reflector_store_crosses_between_the_packages(producer):
    """A store made by one package replays through the other's apply_q2
    and apply_q1 (utils/convert carriers), giving eigenvectors of a."""
    n, b = 128, 16
    a, _ = random_spd_pair(n, seed=114)
    if producer == "jax":
        ab, vs, ts = (np.asarray(x) for x in j_sbrd.sbrd(a, band=b))
        d, e, vt, taut = (np.asarray(x) for x in
                          j_sb2st.bulge_chase(j_sb2st.dense_to_band(ab, b), b))
    else:
        ab, vs, ts = t_sbrd.sbrd(torch.from_numpy(a), band=b)
        d, e, vt, taut = (x.numpy() for x in
                          t_sb2st.bulge_chase(t_sb2st.dense_to_band(ab, b), b))
        ab, vs, ts = ab.numpy(), vs.numpy(), ts.numpy()
    w, y = np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    if producer == "jax":
        _, tvs, tts = sbrd_from_numpy(ab, vs, ts, b, device="cpu", dtype=torch.float64)
        _, _, tvt, ttaut = chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
        assert tvt.is_contiguous() and tvt.dtype == torch.float64
        z = t_sbrd.apply_q1(tvs, tts, t_sb2st.apply_q2(tvt, ttaut, torch.from_numpy(y), n, b))
        z = z.numpy()
    else:
        z = np.asarray(j_sbrd.apply_q1(vs, ts, j_sb2st.apply_q2(vt, taut, y, n, b)))
    assert np.abs(a @ z - z * w[None, :]).max() < 1e-11 * n


def test_carriers_check_the_layout():
    with pytest.raises(ValueError):
        band_from_numpy(np.zeros((10, 5)), 2, device="cpu")
    with pytest.raises(ValueError):
        chase_from_numpy(np.zeros(10), np.zeros(9), np.zeros((24, 2, 2)), np.zeros((24, 1)),
                         10, 2, device="cpu")
    with pytest.raises(ValueError):
        sbrd_from_numpy(np.zeros((64, 64)), np.zeros((2, 64, 16)), np.zeros((3, 16, 16)), 16,
                        device="cpu")
    band = band_from_numpy(np.ones((10, 4), dtype=np.float32), 2, device="cpu", dtype=torch.float64)
    assert band.dtype == torch.float64 and band.is_contiguous()
