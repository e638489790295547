"""The port's real two-stage pipeline under a batch axis, on the CPU: each
batched stage (ops/sbrd.sbrd and apply_q1, ops/sb2st.bulge_chase and
apply_q2, ops/replay.window_store and window_qs) and the three kernel
wrappers on CPU tensors (ql_panel, bulge_chase_kernel, apply_q2_kernel)
against jax.vmap of the JAX function and against the port's unbatched call
on each item; then ``sygvdx_batched(tridiag_mode='two')``, in fp64 and
``mp``, and fp64 ``'auto'`` past ``two_stage_min_n``, against the JAX
package's ``sygvdx_batched`` in fp64. The JAX oracle of both modes is its
fp64 solve: the mixed JAX driver's compile takes 30-40 s at n = 48 on the
CPU (most of it its ozaki refinement's graph), and both JAX modes are
fp64-accurate, which is what the bars hold.

Inputs: a batch of 3 at n = 48, band 8, from test_torch_batched_helpers'
pair_batch (A of random_spd_pair(48, seed=100 + k)), in fp64 and fp32.
Tolerances, relative to the largest entry of the input (the bars of
test_torch_batched_two_stage.py): fp64 1e-12 n for the band reduction
(band, factors, Q1 ab Q1^T = a), 1e-11 elementwise for the chase, 1e-11 n
for the tridiagonal's spectrum and for Q2 z; fp32 3e-6 n throughout, the
chase's outputs at 1e-4. An item against its unbatched call: 1e-13 n
(fp64) and 1e-6 n (fp32), sums in another order inside the batched library
products. The driver is held to JAX's own bars (tests/test_batched.py):
eigenvalues within 1e-10 n of JAX and of scipy, ge_residual < 1e-12, info
exact."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.ops.replay_pallas import window_qs as jax_window_qs
from eigensolver_gpu_tpu.parallel.sharded import sygvdx_batched as jax_batched
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.ops import sbrd as t_sbrd
from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
from eigensolver_gpu_torch.ops.ql_panel import ql_panel, ql_panel_plain
from test_torch_batched_helpers import (
    LEAF,
    MODES,
    check_against_single,
    check_items,
    pair_batch,
)

# the JAX ops package re-exports functions under its modules' names
j_sb2st = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st")
j_sbrd = importlib.import_module("eigensolver_gpu_tpu.ops.sbrd")

torch.set_num_threads(2)

BATCH, N, BAND, IU = 3, 48, 8, 8
G = 3 * BAND  # the replay's group size in fp32
# dtype: (torch dtype, jax dtype, tolerance per n, item tolerance per n)
DTYPES = {"fp64": (torch.float64, jnp.float64, 1e-12, 1e-13),
          "fp32": (torch.float32, jnp.float32, 3e-6, 1e-6)}


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """The batch's symmetric A, float64 (3, 48, 48), in the dtype as a
    torch tensor and as a jax array."""
    tdt, jdt = DTYPES[name][:2]
    a, _ = pair_batch(BATCH, N, seed=100, cplx=False)
    return a, torch.tensor(a, dtype=tdt), jnp.asarray(a, jdt)


@functools.lru_cache(maxsize=None)
def _stages(name):
    """The port's batched stages and the vmapped JAX ones on the same input:
    sbrd, the band and the plain chase."""
    _, at, ja = _inputs(name)
    got = t_sbrd.sbrd(at, band=BAND)
    want = jax.vmap(functools.partial(j_sbrd.sbrd, band=BAND))(ja)
    band = t_sb2st.dense_to_band(got[0], BAND)
    chase = t_sb2st.bulge_chase(band, BAND)
    jchase = jax.vmap(lambda x: j_sb2st.bulge_chase(x, BAND))(jnp.asarray(band.numpy()))
    return got, want, band, chase, jchase


def _scale(name):
    return float(np.abs(_inputs(name)[0]).max())


def _jx(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_dense_to_band_and_sbrd_match_vmapped_jax(name):
    """Band, vs and ts of the batched sbrd elementwise against jax.vmap of
    JAX's sbrd and against the unbatched sbrd of each item; dense_to_band
    of the batch against vmapped JAX's; and per item Q1 ab Q1^T = a with Q1
    from the batched apply_q1."""
    tol, item_tol = DTYPES[name][2] * N * _scale(name), DTYPES[name][3] * N * _scale(name)
    a, at, _ = _inputs(name)
    got, want, band, _, _ = _stages(name)
    npanels = N // BAND - 1
    shapes = [(BATCH, N, N), (BATCH, npanels, N, BAND), (BATCH, npanels, BAND, BAND)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape and g.dtype == DTYPES[name][0]
        assert _err(g, w) <= tol
    jband = jax.vmap(lambda x: j_sb2st.dense_to_band(x, BAND))(_jx(got[0]))
    assert tuple(band.shape) == (BATCH, N, 2 * BAND) and _err(band, jband) == 0.0
    for k in range(BATCH):
        one = t_sbrd.sbrd(at[k], band=BAND)
        assert all(_err(g[k], w) <= item_tol for g, w in zip(got, one))
        assert torch.equal(t_sb2st.dense_to_band(got[0][k], BAND), band[k])
    eye = torch.eye(N, dtype=at.dtype).expand(BATCH, N, N)
    q1 = t_sbrd.apply_q1(got[1], got[2], eye).double().numpy()
    ab = got[0].double().numpy()
    for k in range(BATCH):
        assert np.abs(q1[k] @ ab[k] @ q1[k].T - a[k]).max() <= tol
        assert np.abs(q1[k] @ q1[k].T - np.eye(N)).max() <= DTYPES[name][2] * N


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_apply_q1_matches_vmapped_jax(name, group):
    """The batched replay of the sbrd factors onto a batch of columns,
    against jax.vmap of JAX's apply_q1 on the same factors and against the
    unbatched replay of each item."""
    tdt, _, tol, item_tol = DTYPES[name]
    got_s = _stages(name)[0]
    y = torch.tensor(np.random.default_rng(30 + group).standard_normal((BATCH, N, 5)), dtype=tdt)
    got = t_sbrd.apply_q1(got_s[1], got_s[2], y, group=group)
    want = jax.vmap(lambda vs, ts, yy: j_sbrd.apply_q1(vs, ts, yy, group=group))(
        _jx(got_s[1]), _jx(got_s[2]), _jx(y))
    assert got.shape == (BATCH, N, 5) and _err(got, want) <= tol * N
    for k in range(BATCH):
        one = t_sbrd.apply_q1(got_s[1][k], got_s[2][k], y[k], group=group)
        assert _err(got[k], one) <= item_tol * N


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_bulge_chase_matches_vmapped_jax(name):
    """The batched plain chase (the batch carried through its tensors)
    against jax.vmap of JAX's: d, e, the reflectors and taus; each item
    against its unbatched chase; each item's tridiagonal keeps the spectrum
    of its A."""
    tdt = DTYPES[name][0]
    f64 = name == "fp64"
    scale = _scale(name)
    a, _, _ = _inputs(name)
    _, _, band, chase, jchase = _stages(name)
    tol = 1e-11 * scale if f64 else 1e-4 * scale
    shapes = [(BATCH, N), (BATCH, N - 1)] + [tuple(x.shape) for x in jchase[2:]]
    for g, w, shape in zip(chase, jchase, shapes):
        assert tuple(g.shape) == shape and g.dtype == tdt
        assert _err(g, w) <= tol
    item_tol = DTYPES[name][3] * N * scale
    spec_tol = (1e-11 if f64 else DTYPES[name][2]) * N * scale
    for k in range(BATCH):
        one = t_sb2st.bulge_chase(band[k], BAND)
        assert all(_err(g[k], w) <= item_tol for g, w in zip(chase, one))
        d, e = chase[0][k].double().numpy(), chase[1][k].double().numpy()
        w = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
        assert np.abs(w - np.linalg.eigvalsh(a[k])).max() <= spec_tol


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_window_store_and_apply_q2_match_vmapped_jax(name):
    """Q2 z of each item's tridiagonal eigenvectors: the batched apply_q2
    against jax.vmap of JAX's and against the unbatched replay of each
    item; the batched window store against each item's unbatched store, and
    its JAX layout (window_qs) against jax.vmap of JAX's window_qs; Q2 z
    diagonalises each band."""
    tdt, _, tol, item_tol = DTYPES[name]
    f64 = name == "fp64"
    scale = _scale(name)
    (ab, _, _), _, _, chase, _ = _stages(name)
    vt, taut = chase[2], chase[3]
    zs = []
    for k in range(BATCH):
        d, e = chase[0][k].double().numpy(), chase[1][k].double().numpy()
        zs.append(np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1)))
    z = torch.tensor(np.stack([x[1] for x in zs]), dtype=tdt)
    got = t_sb2st.apply_q2(vt, taut, z, N, BAND, g=G)
    want = jax.vmap(lambda v, t, yy: j_sb2st.apply_q2(v, t, yy, N, BAND, g=G))(
        _jx(vt), _jx(taut), _jx(z))
    q2_tol = (1e-11 if f64 else tol) * N
    assert got.shape == (BATCH, N, N) and _err(got, want) <= q2_tol
    store, table = t_replay.window_store(vt, taut, N, BAND, G)
    assert store.shape == (BATCH, len(table["row0"]), 128, 128)
    for k in range(BATCH):
        one = t_sb2st.apply_q2(vt[k], taut[k], z[k], N, BAND, g=G)
        assert _err(got[k], one) <= item_tol * N
        assert _err(store[k], t_replay.window_store(vt[k], taut[k], N, BAND, G)[0]) \
            <= item_tol * N
        q2z = got[k].double().numpy()
        dense = ab[k].double().numpy()  # the band matrix
        assert np.abs(dense @ q2z - q2z * zs[k][0][None, :]).max() <= q2_tol * scale
    if not f64:
        qw = t_replay.window_qs(vt, taut, N, BAND, G)
        jqw = np.asarray(jax.vmap(lambda v, t: jax_window_qs(v, t, N, BAND, G))(_jx(vt),
                                                                               _jx(taut)))
        assert qw.shape == jqw.shape and _err(qw, jqw) < 1e-5


@pytest.mark.parametrize("name", ["fp64", "fp32"])
def test_the_three_wrappers_take_a_batch_on_the_cpu(name):
    """ql_panel (K5), bulge_chase_kernel (K7) and apply_q2_kernel (K9) on
    batched CPU tensors take their plain versions: the panel against
    jax.vmap of JAX's panel and larft on column slices of the batch (a
    batch stride and a row stride of their own), each wrapper's output
    against its unbatched call on each item; no launch is counted."""
    tdt, _, tol, item_tol = DTYPES[name]
    scale = _scale(name)
    _, at, ja = _inputs(name)
    _, _, band, chase, _ = _stages(name)
    launches = (ql_panel.launches, bulge_chase_kernel.launches, t_replay.apply_q2_kernel.launches)
    rb = N - 2 * BAND
    p = at[:, :, N - BAND :]
    got = ql_panel(p, rb)

    def jax_panel(x):
        r, v, tau = j_sbrd._ql_panel(x, rb)
        return r, v, tau, j_sbrd._larft_forward(v, tau)

    want = jax.vmap(jax_panel)(ja[:, :, N - BAND :])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape[0] == BATCH and tuple(g.shape) == w.shape
        assert _err(g, w) <= tol * N * scale
    assert all(torch.equal(g, w) for g, w in zip(got, ql_panel_plain(p, rb)))
    for k in range(BATCH):
        one = ql_panel(p[k], rb)
        assert all(_err(g[k], w) <= item_tol * N * scale for g, w in zip(got, one))
    ch = bulge_chase_kernel(band, BAND)
    assert all(torch.equal(x, y) for x, y in zip(ch, chase))
    vt, taut = chase[2], chase[3]
    y = torch.tensor(np.random.default_rng(33).standard_normal((BATCH, N, 7)), dtype=tdt)
    q2 = t_replay.apply_q2_kernel(vt, taut, y, N, BAND, g=G)
    assert q2.shape == (BATCH, N, 7)
    assert torch.equal(q2, t_sb2st.apply_q2(vt, taut, y, N, BAND, g=G))
    for k in range(BATCH):
        one = t_replay.apply_q2_kernel(vt[k], taut[k], y[k], N, BAND, g=G)
        assert _err(q2[k], one) <= item_tol * N
    with pytest.raises(ValueError):
        t_replay.apply_q2_kernel(vt, taut, y[0], N, BAND, g=G)
    assert launches == (ql_panel.launches, bulge_chase_kernel.launches,
                        t_replay.apply_q2_kernel.launches)


TWO = dict(tridiag_mode="two", band=BAND)
AUTO = dict(two_stage_min_n=32, band=BAND)  # fp64 'auto': two-stage at n >= 32


def _driver_batches():
    a, b = pair_batch(BATCH, N, seed=100, cplx=False)
    bad = b.copy()
    bad[1, 0, 0] = -50.0  # item 1 not positive definite: info 1
    a46, b46 = pair_batch(BATCH, 46, seed=100, cplx=False)  # padded to 48
    return {"pd": (a, b), "non_pd": (a, bad), "n46": (a46, b46)}


def _jax_solve(name, mode, kw):
    a, b = _driver_batches()[name]
    w, z, info = jax_batched(jnp.asarray(a), jnp.asarray(b), il=1, iu=IU,
                             cfg=JaxConfig(stedc_leaf=LEAF, **kw, **MODES[mode]))
    return np.asarray(w), np.asarray(z), np.asarray(info)


@pytest.fixture(scope="module")
def jax_two_stage():
    """JAX's batched two-stage solves in fp64 (jax.vmap of its sygvdx with
    tridiag_mode='two'; see the module docstring), each shape compiled once
    for the module: pd, non_pd and n46, and 'auto' past two_stage_min_n
    (the same program as pd)."""
    out = {name: _jax_solve(name, "fp64", TWO) for name in ("pd", "non_pd", "n46")}
    out["auto"] = _jax_solve("pd", "fp64", AUTO)
    return out


def _calls(monkeypatch):
    """Log the batch shape each real two-stage wrapper is given, and each
    unbatched sygvdx call."""
    import eigensolver_gpu_torch.parallel.sharded as sharded
    from eigensolver_gpu_torch.ops import chase

    log = {}

    def logged(mod, name, shape_of):
        fn, calls = getattr(mod, name), log.setdefault(name, [])
        monkeypatch.setattr(mod, name, lambda *args, **k: calls.append(shape_of(args))
                            or fn(*args, **k))

    import eigensolver_gpu_torch.ops.ql_panel as qlp

    logged(qlp, "ql_panel", lambda args: tuple(args[0].shape))
    logged(chase, "bulge_chase_kernel", lambda args: tuple(args[0].shape))
    logged(t_replay, "apply_q2_kernel", lambda args: tuple(args[2].shape))
    logged(sharded, "sygvdx", lambda args: tuple(args[0].shape))
    return log


@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_batched_two_stage_driver_matches_jax(jax_two_stage, monkeypatch, mode):
    """sygvdx_batched(tridiag_mode='two', band=8) is one batched solve (no
    unbatched sygvdx call; one ql_panel call a panel, one bulge_chase_kernel
    and one apply_q2_kernel call, each on the whole batch), held against
    JAX's batched two-stage driver (fp64, see the module docstring) and
    against the port's unbatched two-stage solve of each item."""
    a, b = _driver_batches()["pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **TWO, **MODES[mode])
    log = _calls(monkeypatch)
    res = eig.sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU, cfg=cfg)
    monkeypatch.undo()
    assert not log["sygvdx"]
    assert [s[0] for s in log["ql_panel"]] == [BATCH] * (N // BAND - 1)
    assert log["bulge_chase_kernel"] == [(BATCH, N, 2 * BAND)]
    assert log["apply_q2_kernel"] == [(BATCH, N, N if mode == "mp" else IU)]
    assert res.w.shape == (BATCH, IU) and res.z.shape == (BATCH, N, IU)
    jw, _, jinfo = jax_two_stage["pd"]
    w, z = res.w.numpy(), res.z.numpy()
    check_items(a, b, w, z, res.info.numpy(), IU, jw=jw, jinfo=jinfo)
    for k in range(BATCH):
        single = eig.sygvdx(torch.from_numpy(a[k]), torch.from_numpy(b[k]), il=1, iu=IU,
                            cfg=cfg)
        assert int(single.info) == 0
        check_against_single(w[k], z[k], (single.w.numpy(), single.z.numpy()), N)


@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_batched_two_stage_non_pd_item_and_padded_n(jax_two_stage, mode):
    """A non-positive-definite B in item 1 sets that item's info (1, as
    JAX's batched solve and the unbatched solve give) and leaves the others
    solved; n = 46 pads to 48 for the two-stage reduction, as in JAX. Both
    modes are held against JAX's fp64 solves and scipy."""
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **TWO, **MODES[mode])
    a, bad = _driver_batches()["non_pd"]
    res = eig.sygvdx_batched(torch.from_numpy(a), torch.from_numpy(bad), il=1, iu=IU, cfg=cfg)
    jw, _, jinfo = jax_two_stage["non_pd"]
    assert res.info.numpy().tolist() == jinfo.tolist() == [0, 1, 0]
    single = eig.sygvdx(torch.from_numpy(a[1]), torch.from_numpy(bad[1]), il=1, iu=IU, cfg=cfg)
    assert int(single.info) == 1
    check_items(a, bad, res.w.numpy(), res.z.numpy(), res.info.numpy(), IU, jw=jw, skip=(1,))
    a46, b46 = _driver_batches()["n46"]
    res = eig.sygvdx_batched(torch.from_numpy(a46), torch.from_numpy(b46), il=1, iu=IU, cfg=cfg)
    assert res.z.shape == (BATCH, 46, IU)
    jw, _, jinfo = jax_two_stage["n46"]
    check_items(a46, b46, res.w.numpy(), res.z.numpy(), res.info.numpy(), IU, jw=jw,
                jinfo=jinfo)


def test_auto_fp64_past_two_stage_min_n_is_one_batched_two_stage_solve(jax_two_stage,
                                                                       monkeypatch):
    """fp64 'auto' with two_stage_min_n = 32 takes the two-stage route at
    n = 48, as in JAX, as one batched solve; held against JAX's batched
    driver with the same configuration."""
    from eigensolver_gpu_torch.models.syevdx import takes_two_stage

    a, b = _driver_batches()["pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **AUTO)
    assert takes_two_stage(N, torch.float64, cfg)
    assert not takes_two_stage(N, torch.float64, eig.SolverConfig(stedc_leaf=LEAF, band=BAND))
    log = _calls(monkeypatch)
    res = eig.sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU, cfg=cfg)
    monkeypatch.undo()
    assert not log["sygvdx"] and log["bulge_chase_kernel"] == [(BATCH, N, 2 * BAND)]
    jw, _, jinfo = jax_two_stage["auto"]
    check_items(a, b, res.w.numpy(), res.z.numpy(), res.info.numpy(), IU, jw=jw, jinfo=jinfo)
