"""The port's planar two-stage pipeline under a batch axis, on the CPU: each
batched stage (ops/sb2st.dense_to_band, ops/sbrd_planar.psbrd and
apply_q1_planar, ops/sb2st_planar.bulge_chase_planar, phase_normalize and
apply_q2_planar, ops/replay.window_store_planar and window_qs_planar) and
the three kernel wrappers on CPU tensors (ql_panel_planar,
bulge_chase_planar_kernel, apply_q2_planar_kernel) against jax.vmap of the
JAX function and against the port's unbatched call on each item; then
``zhegvdx_planar_batched(tridiag_mode='two')`` against the JAX package's
batched driver (its fp64 mode, for both of the port's modes).

Inputs: a batch of 3 at n = 32, band 8, from test_torch_batched_helpers'
pair_batch (A of random_hpd_pair(32, seed=100 + k)), in fp64 and fp32.
Tolerances, relative to the largest entry of the input: fp64 1e-12 n for
the band reduction (band, factors, Q1 ab Q1^H = a), the
test_torch_planar_two_stage_ops bars for the chase (1e-11 elementwise) and
phase_normalize (1e-13, |e| exact), 1e-11 n for the tridiagonal's spectrum
and for Q2 D z; fp32 3e-6 n throughout (fp32 round-off over sums of n
terms), the chase's outputs at 1e-4, phase_normalize at the fp32 bars of
test_torch_planar_two_stage_ops (1e-5, one ulp of |e|). An item against
its unbatched call: 1e-13 n (fp64) and 1e-6 n (fp32), sums in another
order inside the batched library products. The driver is held to JAX's own
bars (tests/test_batched.py): eigenvalues within 1e-10 n of JAX and of
scipy, ge_residual < 1e-12, info exact."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_batched as jax_batched
from eigensolver_gpu_tpu.ops.replay_pallas import window_qs_planar as jax_window_qs_planar
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.ops import sb2st_planar as t_sp
from eigensolver_gpu_torch.ops import sbrd_planar as t_sbrd
from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar, ql_panel_planar_plain
from test_torch_batched_helpers import (
    LEAF,
    MODES,
    as_complex,
    check_against_single,
    check_items,
    pair_batch,
    planar_single,
    planes,
)

# the JAX ops package re-exports functions under its modules' names
j_sb2st = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st")
j_sp = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st_planar")
j_sbrd = importlib.import_module("eigensolver_gpu_tpu.ops.sbrd_planar")

torch.set_num_threads(2)

BATCH, N, BAND, IU = 3, 32, 8, 8
G = 3 * BAND  # the replay's group size in fp32
# dtype: (torch dtype, jax dtype, tolerance per n, item tolerance per n)
DTYPES = {"fp64": (torch.float64, jnp.float64, 1e-12, 1e-13),
          "fp32": (torch.float32, jnp.float32, 3e-6, 1e-6)}


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """The batch's Hermitian A, complex128 (3, 32, 32), and its planes in
    the dtype, as torch tensors and as jax arrays."""
    tdt, jdt = DTYPES[name][:2]
    a, _ = pair_batch(BATCH, N, seed=100)
    t = tuple(torch.tensor(np.ascontiguousarray(x), dtype=tdt) for x in (a.real, a.imag))
    j = tuple(jnp.asarray(np.ascontiguousarray(x), jdt) for x in (a.real, a.imag))
    return a, t, j


@functools.lru_cache(maxsize=None)
def _stages(name):
    """The port's batched stages and the vmapped JAX ones on the same input:
    psbrd, the band planes and the chase with phase_normalize."""
    a, (ar, ai), (jar, jai) = _inputs(name)
    got = t_sbrd.psbrd(ar, ai, band=BAND)
    want = jax.vmap(functools.partial(j_sbrd.psbrd, band=BAND))(jar, jai)
    band = tuple(t_sb2st.dense_to_band(x, BAND) for x in got[0])
    chase = t_sp.bulge_chase_planar(*band, BAND)
    jband = tuple(jnp.asarray(x.numpy()) for x in band)
    jchase = jax.vmap(lambda r, i: j_sp.bulge_chase_planar(r, i, BAND))(*jband)
    return got, want, band, chase, jchase


def _scale(name):
    return float(np.abs(_inputs(name)[0]).max())


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_dense_to_band_and_psbrd_match_vmapped_jax(name):
    """Band, vs and ts of the batched psbrd, both planes, elementwise
    against jax.vmap of JAX's psbrd and against the unbatched psbrd of
    each item; dense_to_band of the batch against vmapped JAX's; and per
    item Q1 ab Q1^H = a with Q1 from the batched apply_q1_planar."""
    tol, item_tol = DTYPES[name][2] * N * _scale(name), DTYPES[name][3] * N * _scale(name)
    a, (ar, ai), _ = _inputs(name)
    got, want, band, _, _ = _stages(name)
    npanels = N // BAND - 1
    shapes = [(BATCH, N, N), (BATCH, npanels, N, BAND), (BATCH, npanels, BAND, BAND)]
    for g, w, shape in zip(got, want, shapes):
        for plane in (0, 1):
            assert tuple(g[plane].shape) == shape and g[plane].dtype == DTYPES[name][0]
            assert _err(g[plane], w[plane]) <= tol
    jband = [jax.vmap(lambda x: j_sb2st.dense_to_band(x, BAND))(jnp.asarray(x.numpy()))
             for x in got[0]]
    for g, w in zip(band, jband):
        assert tuple(g.shape) == (BATCH, N, 2 * BAND) and _err(g, w) == 0.0
    for k in range(BATCH):
        one = t_sbrd.psbrd(ar[k], ai[k], band=BAND)
        for g, w in zip(got, one):
            assert all(_err(g[plane][k], w[plane]) <= item_tol for plane in (0, 1))
        assert torch.equal(t_sb2st.dense_to_band(got[0][0][k], BAND), band[0][k])
    eye = torch.eye(N, dtype=ar.dtype).expand(BATCH, N, N)
    q1 = as_complex(*t_sbrd.apply_q1_planar(got[1], got[2], (eye, torch.zeros_like(eye))))
    ab = as_complex(*got[0])
    for k in range(BATCH):
        assert np.abs(q1[k] @ ab[k] @ q1[k].conj().T - a[k]).max() <= tol
        assert np.abs(q1[k] @ q1[k].conj().T - np.eye(N)).max() <= DTYPES[name][2] * N


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_apply_q1_planar_matches_vmapped_jax(name, group):
    """The batched replay of the psbrd factors onto a batch of planar
    columns, against jax.vmap of JAX's apply_q1_planar on the same factors
    and against the unbatched replay of each item."""
    tdt, jdt, tol, item_tol = DTYPES[name]
    got_ps, _, _, _, _ = _stages(name)
    rng = np.random.default_rng(30 + group)
    y = tuple(torch.tensor(rng.standard_normal((BATCH, N, 5)), dtype=tdt) for _ in range(2))
    got = t_sbrd.apply_q1_planar(got_ps[1], got_ps[2], y, group=group)
    jarg = lambda p: tuple(jnp.asarray(x.numpy()) for x in p)
    want = jax.vmap(lambda vs, ts, yy: j_sbrd.apply_q1_planar(vs, ts, yy, group=group))(
        jarg(got_ps[1]), jarg(got_ps[2]), jarg(y))
    for plane in (0, 1):
        assert got[plane].shape == (BATCH, N, 5) and _err(got[plane], want[plane]) <= tol * N
    for k in range(BATCH):
        one = t_sbrd.apply_q1_planar(tuple(x[k] for x in got_ps[1]),
                                     tuple(x[k] for x in got_ps[2]),
                                     (y[0][k], y[1][k]), group=group)
        assert all(_err(got[plane][k], one[plane]) <= item_tol * N for plane in (0, 1))


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_bulge_chase_planar_and_phase_normalize_match_vmapped_jax(name):
    """The batched plain chase (the batch carried through its tensors) and
    the batched phase_normalize against jax.vmap of JAX's: d, e, the reflectors and
    taus, the phases and |e|; each item's tridiagonal (d, |e|) keeps the
    spectrum of its A."""
    tdt = DTYPES[name][0]
    f64 = name == "fp64"
    scale = _scale(name)
    a, _, _ = _inputs(name)
    _, _, band, chase, jchase = _stages(name)
    tol = 1e-11 * scale if f64 else 1e-4 * scale
    assert tuple(chase[0].shape) == (BATCH, N) and chase[0].dtype == tdt
    assert _err(chase[0], jchase[0]) <= tol
    for k in (1, 2, 3):
        for plane in (0, 1):
            assert chase[k][plane].shape == jchase[k][plane].shape
            assert _err(chase[k][plane], jchase[k][plane]) <= tol
    item_tol = DTYPES[name][3] * N * scale
    for k in range(BATCH):
        one = t_sp.bulge_chase_planar(band[0][k], band[1][k], BAND)
        assert _err(chase[0][k], one[0]) <= item_tol
        assert all(_err(chase[j][p][k], one[j][p]) <= item_tol
                   for j in (1, 2, 3) for p in (0, 1))
    (p_r, p_i), mag = t_sp.phase_normalize(*chase[1])
    (jp_r, jp_i), jmag = jax.vmap(j_sp.phase_normalize)(
        jnp.asarray(chase[1][0].numpy()), jnp.asarray(chase[1][1].numpy()))
    assert p_r.shape == (BATCH, N) and mag.shape == (BATCH, N - 1)
    assert _err(p_r, jp_r) <= (1e-13 if f64 else 1e-5)
    assert _err(p_i, jp_i) <= (1e-13 if f64 else 1e-5)
    assert _err(mag, jmag) <= (0.0 if f64 else 2.4e-7)
    spec_tol = (1e-11 if f64 else DTYPES[name][2]) * N * scale
    for k in range(BATCH):
        (o_r, o_i), omag = t_sp.phase_normalize(chase[1][0][k], chase[1][1][k])
        assert max(_err(o_r, p_r[k]), _err(o_i, p_i[k]), _err(omag, mag[k])) <= item_tol
        d, e = chase[0][k].double().numpy(), mag[k].double().numpy()
        w = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
        assert np.abs(w - np.linalg.eigvalsh(a[k])).max() <= spec_tol


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_window_store_and_apply_q2_planar_match_vmapped_jax(name):
    """Q2 D z of each item's tridiagonal eigenvectors: the batched
    apply_q2_planar against jax.vmap of JAX's and against the unbatched
    replay of each item; the batched window store against each item's
    unbatched store, and its JAX layout (window_qs_planar) against
    jax.vmap of JAX's window_qs_planar; Q2 D z diagonalises each band."""
    tdt, jdt, tol, item_tol = DTYPES[name]
    f64 = name == "fp64"
    scale = _scale(name)
    (ab, _, _), _, _, chase, _ = _stages(name)
    vt, taut = chase[2], chase[3]
    (p_r, p_i), mag = t_sp.phase_normalize(*chase[1])
    zs = []
    for k in range(BATCH):
        d, e = chase[0][k].double().numpy(), mag[k].double().numpy()
        zs.append(np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1)))
    z = torch.tensor(np.stack([x[1] for x in zs]), dtype=tdt)
    y = (z * p_r[..., None], z * p_i[..., None])
    got = t_sp.apply_q2_planar(vt, taut, y, N, BAND, g=G)
    jarg = lambda p: tuple(jnp.asarray(x.numpy()) for x in p)
    want = jax.vmap(lambda v, t, yy: j_sp.apply_q2_planar(v, t, yy, N, BAND, g=G))(
        jarg(vt), jarg(taut), jarg(y))
    q2_tol = (1e-11 if f64 else tol) * N
    for plane in (0, 1):
        assert got[plane].shape == (BATCH, N, N) and _err(got[plane], want[plane]) <= q2_tol
    store, table = t_replay.window_store_planar(vt, taut, N, BAND, G)
    n_valid = len(table["row0"])
    assert store.shape == (2, BATCH, n_valid, 128, 128)
    for k in range(BATCH):
        item = (tuple(x[k] for x in vt), tuple(x[k] for x in taut))
        one = t_sp.apply_q2_planar(*item, (y[0][k], y[1][k]), N, BAND, g=G)
        assert all(_err(got[plane][k], one[plane]) <= item_tol * N for plane in (0, 1))
        one_store, _ = t_replay.window_store_planar(*item, N, BAND, G)
        assert _err(store[:, k], one_store) <= item_tol * N
        q2dz = as_complex(got[0][k].double(), got[1][k].double())
        dense = as_complex(ab[0][k].double(), ab[1][k].double())  # the band matrix
        assert np.abs(dense @ q2dz - q2dz * zs[k][0][None, :]).max() <= q2_tol * scale
    if not f64:
        qw = t_replay.window_qs_planar(vt, taut, N, BAND, G)
        jqw = np.asarray(jax.vmap(lambda v, t: jax_window_qs_planar(v, t, N, BAND, G))(
            jarg(vt), jarg(taut)))
        assert qw.shape == (2,) + jqw.shape[:3] + (128, 128)
        assert _err(torch.cat([qw[0], qw[1]], dim=-1), jqw) < 1e-5


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_the_three_wrappers_take_a_batch_on_the_cpu(name):
    """ql_panel_planar (K6), bulge_chase_planar_kernel (K8) and
    apply_q2_planar_kernel (K10) on batched CPU tensors take their plain
    versions: the panel against jax.vmap of JAX's panel and larft on
    column slices of the batch's planes (a batch stride and a row stride of
    their own), each wrapper's output against its unbatched call on each
    item; no launch is counted."""
    tdt, jdt, tol, item_tol = DTYPES[name]
    scale = _scale(name)
    _, (ar, ai), (jar, jai) = _inputs(name)
    _, _, band, chase, _ = _stages(name)
    launches = (ql_panel_planar.launches, bulge_chase_planar_kernel.launches,
                t_replay.apply_q2_planar_kernel.launches)
    rb = N - 2 * BAND
    pr, pi = ar[:, :, N - BAND :], ai[:, :, N - BAND :]
    got = ql_panel_planar(pr, pi, rb)

    def jax_panel(r, i):
        pf_r, pf_i, v_r, v_i, t_r, t_i = j_sbrd._ql_panel_planar(r, i, rb)
        return (pf_r, pf_i, v_r, v_i, t_r, t_i) + tuple(
            j_sbrd._larft_forward_planar(v_r, v_i, t_r, -t_i))

    want = jax.vmap(jax_panel)(jar[:, :, N - BAND :], jai[:, :, N - BAND :])
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape[0] == BATCH and tuple(g.shape) == w.shape
        assert _err(g, w) <= tol * N * scale
    assert all(torch.equal(g, w) for g, w in zip(got, ql_panel_planar_plain(pr, pi, rb)))
    for k in range(BATCH):
        one = ql_panel_planar(pr[k], pi[k], rb)
        assert all(_err(g[k], w) <= item_tol * N * scale for g, w in zip(got, one))
    ch = bulge_chase_planar_kernel(*band, BAND)
    assert torch.equal(ch[0], chase[0])
    assert all(torch.equal(ch[j][p], chase[j][p]) for j in (1, 2, 3) for p in (0, 1))
    vt, taut = chase[2], chase[3]
    rng = np.random.default_rng(33)
    y = tuple(torch.tensor(rng.standard_normal((BATCH, N, 7)), dtype=tdt) for _ in range(2))
    q2 = t_replay.apply_q2_planar_kernel(vt, taut, y, N, BAND, g=G)
    plain = t_sp.apply_q2_planar(vt, taut, y, N, BAND, g=G)
    assert all(torch.equal(q2[p], plain[p]) and q2[p].shape == (BATCH, N, 7) for p in (0, 1))
    for k in range(BATCH):
        one = t_replay.apply_q2_planar_kernel(tuple(x[k] for x in vt),
                                              tuple(x[k] for x in taut),
                                              (y[0][k], y[1][k]), N, BAND, g=G)
        assert all(_err(q2[p][k], one[p]) <= item_tol * N for p in (0, 1))
    assert launches == (ql_panel_planar.launches, bulge_chase_planar_kernel.launches,
                        t_replay.apply_q2_planar_kernel.launches)


TWO = dict(tridiag_mode="two", band=BAND)


def _driver_batches():
    a, b = pair_batch(BATCH, N, seed=100)
    bad = b.copy()
    bad[1, 9, 9] = -50.0  # item 1 not positive definite: devInfo column 10
    a30, b30 = pair_batch(BATCH, 30, seed=100)  # padded to 32 for the reduction
    return {"pd": (a, b), "non_pd": (a, bad), "n30": (a30, b30)}


@pytest.fixture(scope="module")
def jax_two_stage():
    """JAX's batched two-stage solves (jax.vmap of its planar driver with
    tridiag_mode='two') in fp64: pd, non_pd and n30. Both modes of the port
    are held against them: the mixed JAX driver compiles for minutes a
    shape on the CPU (most of it its ozaki refinement's graph), and its
    output and the fp64 one are both fp64-accurate, which is what the bars
    hold."""
    out = {}
    for mode, name in (("fp64", "pd"), ("fp64", "non_pd"), ("fp64", "n30")):
        a, b = _driver_batches()[name]
        w, zr, zi, info = jax_batched(a.real, a.imag, b.real, b.imag, il=1, iu=IU,
                                      cfg=JaxConfig(stedc_leaf=LEAF, **TWO, **MODES[mode]))
        out[mode, name] = (np.asarray(w), np.asarray(zr) + 1j * np.asarray(zi),
                           np.asarray(info))
    return out


@pytest.mark.parametrize("chunk", [None, 1])
@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_batched_two_stage_driver_matches_jax(jax_two_stage, mode, chunk):
    """zhegvdx_planar_batched(tridiag_mode='two', band=8) against JAX's
    batched two-stage driver (fp64, see the fixture) and against the
    port's unbatched two-stage solve of each item."""
    a, b = _driver_batches()["pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **TWO, **MODES[mode])
    res = eig.zhegvdx_planar_batched(*planes(a, b), il=1, iu=IU, cfg=cfg, chunk=chunk)
    assert res.w.shape == (BATCH, IU) and res.zr.shape == res.zi.shape == (BATCH, N, IU)
    w, z = res.w.numpy(), as_complex(res.zr, res.zi)
    jw, _, jinfo = jax_two_stage["fp64", "pd"]
    check_items(a, b, w, z, res.info.numpy(), IU, jw=jw, jinfo=jinfo)
    for k in range(BATCH):
        sw, sz, sinfo = planar_single(a[k], b[k], IU, cfg)
        assert sinfo == 0
        check_against_single(w[k], z[k], (sw, sz), N)


@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_batched_two_stage_non_pd_item_and_padded_n(jax_two_stage, mode):
    """A non-positive-definite B in item 1 sets that item's info (10, as
    JAX's fp64 batched solve and the unbatched solve give) and leaves the
    others solved; n = 30 pads to 32 for the two-stage reduction, as in
    JAX. Both modes are held against JAX's fp64 solves and scipy."""
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **TWO, **MODES[mode])
    a, bad = _driver_batches()["non_pd"]
    res = eig.zhegvdx_planar_batched(*planes(a, bad), il=1, iu=IU, cfg=cfg)
    jw, _, jinfo = jax_two_stage["fp64", "non_pd"]
    assert res.info.numpy().tolist() == jinfo.tolist() == [0, 10, 0]
    assert planar_single(a[1], bad[1], IU, cfg)[2] == 10
    check_items(a, bad, res.w.numpy(), as_complex(res.zr, res.zi), res.info.numpy(), IU,
                jw=jw, skip=(1,))
    a30, b30 = _driver_batches()["n30"]
    res = eig.zhegvdx_planar_batched(*planes(a30, b30), il=1, iu=IU, cfg=cfg)
    assert res.zr.shape == (BATCH, 30, IU)
    jw, _, jinfo = jax_two_stage["fp64", "n30"]
    check_items(a30, b30, res.w.numpy(), as_complex(res.zr, res.zi), res.info.numpy(), IU,
                jw=jw, jinfo=jinfo)
    for k in range(BATCH):
        sw, sz, _ = planar_single(a30[k], b30[k], IU, cfg)
        check_against_single(res.w[k].numpy(), as_complex(res.zr[k], res.zi[k]), (sw, sz), 30)
