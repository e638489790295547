"""The port's sharded solves (eigensolver_gpu_torch/parallel/) in one gloo
world of four CPU ranks, against the JAX package's sharded entries on the
virtual CPU mesh of tests/conftest.py and against the port's unsharded
solves.

One world runs every case of the module (``run_calls`` of
parallel/dryrun.py, defined in the port so that the ranks import neither
JAX nor this file); each case is a call of a sharded entry on a mesh
made by ``make_mesh``, every rank passing the whole inputs, and rank 0's
outputs come back with the collectives the call made. The JAX oracles
(three sharded entries and ``stedc(mesh=...)``, each one compile) and the
unsharded port solves run here, in the test process.

Bars: against JAX, those of JAX's tests/test_parallel.py for the case
(eigenvalues within 1e-11 of scipy and of JAX, ``ge_residual`` < 1e-12;
the planar batch 1e-10 n); stedc as tests/test_torch_stedc_compact.py
holds it to JAX; against the port's unsharded solve (the branches of
``_sharded_step_body`` JAX's oracle is not run for), eigenvalues within
1e-12 n, vectors phase-insensitively within 1e-8 (``compare_vectors``),
``ge_residual`` < 1e-12 and ``info`` exact.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.ops.stedc import stedc as jax_stedc
from eigensolver_gpu_tpu.parallel import make_mesh as jax_mesh
from eigensolver_gpu_tpu.parallel import sygvdx_batched_sharded as jax_batched_sharded
from eigensolver_gpu_tpu.parallel import sygvdx_sharded as jax_sharded
from eigensolver_gpu_tpu.parallel import zhegvdx_planar_batched_sharded as jax_planar_sharded
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.parallel.dryrun import run_calls, run_world
from eigensolver_gpu_torch.utils.testing import (
    compare_vectors,
    ge_residual,
    random_hpd_pair,
    random_spd_pair,
)

torch.set_num_threads(2)

WORLD = 4
LEAF = 16
TP = (4, 1)  # make_mesh(4): all four ranks on 'tp'
DP = (4, 2)  # make_mesh(4, dp=2)
MIXED = dict(compute_dtype="float32", refine_iters=2)


def _cfg(**kw):
    return eig.SolverConfig(stedc_leaf=LEAF, **kw)


def _trash(x, seed):
    """x with garbage in its strict lower triangle (UPLO='U' reads none)."""
    rng = np.random.default_rng(seed)
    return x + np.tril(rng.standard_normal(x.shape), -1) * 1e3


def _batch(make, batch, n, seed):
    pairs = [make(n, seed=seed + k) for k in range(batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _planes(a, b):
    return tuple(np.ascontiguousarray(x) for x in (a.real, a.imag, b.real, b.imag))


def _tridiagonal(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _heavy_deflation(n):
    """Clusters of equal diagonal entries coupled by 1e-13 (most poles
    deflate), as tests/test_torch_stedc_compact.py's, at n."""
    d = np.repeat(np.linspace(1.0, 3.0, 5), n // 5)
    e = np.full(n - 1, 1e-13)
    e[:: n // 5] = 0.5
    return d, e


# the generalized cases solved by sygvdx_sharded: (n, seed, il, iu, cfg, mesh)
SOLVES = {
    "fp64": (64, 20, 1, 16, _cfg(), TP),
    "mixed": (64, 21, 5, 20, _cfg(**MIXED), TP),
    "trinv": (512, 22, 1, 64, eig.SolverConfig(**MIXED), TP),
    "blocked": (64, 23, 1, 16, _cfg(sygst_mode="blocked", nb_sygst=16), TP),
    "blocked_mixed": (512, 23, 1, 32, eig.SolverConfig(sygst_mode="blocked", **MIXED), TP),
    "two_stage": (64, 24, 1, 16, _cfg(tridiag_mode="two", band=8), TP),
    "two_stage_mixed": (64, 25, 1, 16, _cfg(tridiag_mode="two", band=8, **MIXED), TP),
    "pallas_mixed": (64, 26, 1, 16, _cfg(use_pallas=True, **MIXED), TP),
    "uneven_tp3": (64, 27, 1, 12, _cfg(), (3, 1)),
    "dp_mesh_tp2": (64, 28, 1, 16, _cfg(tridiag_mode="two", band=8), DP),
}


def _solve_inputs(name):
    n, seed = SOLVES[name][:2]
    return random_spd_pair(n, seed=seed)


def _cases():
    cases = {}
    for name, (n, seed, il, iu, cfg, mesh) in SOLVES.items():
        cases[name] = ("sygvdx_sharded", _solve_inputs(name), dict(il=il, iu=iu, cfg=cfg), mesh)
    a, b = _solve_inputs("fp64")
    cases["uplo"] = ("sygvdx_sharded", (_trash(a, 124), _trash(b, 125)),
                     dict(il=1, iu=16, cfg=_cfg()), TP)
    cases["dp"] = ("sygvdx_batched_sharded", _batch(random_spd_pair, 4, 32, 40),
                   dict(il=1, iu=4, cfg=_cfg()), DP)
    cases["dp_two_stage_mixed"] = ("sygvdx_batched_sharded", _batch(random_spd_pair, 8, 32, 60),
                                   dict(il=1, iu=4, cfg=_cfg(tridiag_mode="two", band=8,
                                                             **MIXED)), DP)
    planar = _planes(*_batch(random_hpd_pair, 8, 48, 100))
    cases["planar_dp"] = ("zhegvdx_planar_batched_sharded", planar,
                          dict(il=1, iu=6, cfg=_cfg()), DP)
    cases["planar_dp_chunk"] = ("zhegvdx_planar_batched_sharded", planar,
                                dict(il=1, iu=6, cfg=_cfg(**MIXED), chunk=4), DP)
    cases["planar_dp_two_stage"] = ("zhegvdx_planar_batched_sharded", planar,
                                    dict(il=1, iu=6, cfg=_cfg(tridiag_mode="two", band=8,
                                                              **MIXED)), TP)
    cases["planar_chunk_not_divisible"] = ("zhegvdx_planar_batched_sharded", planar,
                                           dict(il=1, iu=6, chunk=2), DP)
    cases["planar_batch_not_divisible"] = ("zhegvdx_planar_batched_sharded",
                                           tuple(x[:3] for x in planar), dict(il=1, iu=6), DP)
    cases["batch_not_divisible"] = ("sygvdx_batched_sharded",
                                    tuple(x[:3] for x in _batch(random_spd_pair, 3, 32, 40)),
                                    dict(il=1, iu=4), TP)
    for name, (d, e) in (("stedc", _tridiagonal(100, 7)), ("stedc_deflation",
                                                           _heavy_deflation(100))):
        cases[name] = ("stedc", (d, e), dict(leaf=LEAF), TP)
    a, x0 = _refine_inputs()
    for gemm in ("native", "ozaki"):
        cases[f"refine_{gemm}"] = ("refine_eigh", (a, x0),
                                   dict(sweeps=2, gemm=gemm, sel=(0, 24), w0=_refine_w0(),
                                        extra_max=2), TP)
    return cases


def _refine_inputs():
    a = random_spd_pair(64, seed=30)[0]
    _, v = np.linalg.eigh(a.astype(np.float32))
    return a, v.astype(np.float64)


def _refine_w0():
    return np.linalg.eigvalsh(_refine_inputs()[0].astype(np.float32)).astype(np.float64)


CASES = _cases()


@pytest.fixture(scope="module")
def world():
    """Every case in one world of WORLD gloo ranks: name -> rank 0's record."""
    names = list(CASES)
    records = run_world(WORLD, run_calls, ([CASES[k] for k in names],))
    return dict(zip(names, records))


def _out(world, name):
    rec = world[name]
    assert "error" not in rec, rec.get("error")
    return rec["out"]


def _unsharded(name):
    n, seed, il, iu, cfg, _ = SOLVES[name]
    a, b = _solve_inputs(name)
    res = eig.sygvdx(torch.tensor(a), torch.tensor(b), il=il, iu=iu, cfg=cfg)
    return res.w.numpy(), res.z.numpy(), int(res.info)


def _check_solve(a, b, w, z, info, il, iu):
    assert int(info) == 0
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)[il - 1 : iu]
    assert w.shape == (iu - il + 1,) and z.shape == (a.shape[0], iu - il + 1)
    assert np.abs(w - w_ref).max() < 1e-10 * a.shape[0]
    assert ge_residual(a, b, w, z) < 1e-12


def test_tp_solve_matches_jax_sygvdx_sharded(world):
    """make_mesh(4), fp64 (JAX's test_sygvdx_sharded_tp on four devices):
    eigenvalues within 1e-11 of JAX's and scipy's, residual < 1e-12; the
    dominant stages communicate (sytrd, stedc's top merges, the
    back-transform)."""
    a, b = _solve_inputs("fp64")
    w, z, info = _out(world, "fp64")
    jw, jz, jinfo = jax_sharded(a, b, jax_mesh(4), il=1, iu=16,
                                cfg=JaxConfig(stedc_leaf=LEAF))
    assert int(info) == int(jinfo) == 0 and info.dtype == np.int32
    assert np.abs(w - np.asarray(jw)).max() < 1e-11
    assert np.abs(w - scipy.linalg.eigh(a, b, eigvals_only=True)[:16]).max() < 1e-11
    assert ge_residual(a, b, w, z) < 1e-12
    assert compare_vectors(z, np.asarray(jz)) < 1e-8
    stages = world["fp64"]["stages"]
    assert stages["sytrd"] > 0 and stages["stedc"] > 0 and stages["back"] > 0


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_each_branch_matches_the_unsharded_solve(world, name):
    """Every branch of ``_sharded_step_body`` (fp64, mixed, the 'trinv'
    full inverse at n = 512, 'blocked' fp64 and mixed, two-stage band 8
    fp64 and mixed, use_pallas, a 3-rank 'tp' (n = 64 does not split, the
    columns do), a dp=2 mesh's 'tp' of 2) against the port's unsharded
    ``sygvdx`` on the same pair."""
    n, _, il, iu, cfg, _ = SOLVES[name]
    a, b = _solve_inputs(name)
    w, z, info = _out(world, name)
    sw, sz, sinfo = _unsharded(name)
    assert int(info) == sinfo == 0
    _check_solve(a, b, w, z, info, il, iu)
    assert np.abs(w - sw).max() < 1e-12 * n
    assert compare_vectors(z, sz) < 1e-8


def test_uplo_contract(world):
    """Garbage in the lower triangles of A and B changes nothing (JAX's
    test_sygvdx_sharded_uplo_contract bars)."""
    w0, z0, _ = _out(world, "fp64")
    w1, z1, info1 = _out(world, "uplo")
    assert int(info1) == 0
    assert np.abs(w1 - w0).max() < 1e-11 * 64
    assert np.abs(np.abs(z1) - np.abs(z0)).max() < 1e-9 * 64


def test_dominant_stages_communicate(world):
    """The twin of JAX's test_sharded_dominant_stages_communicate: the
    n = 512 mixed solve under four ranks made collectives in the
    reduction to standard form and phase 4 (the full inverse), sytrd,
    stedc's top merges, the back-transform and the refinement; a solve of
    the data-parallel entry made none inside its solves, only the
    gathers of its outputs (three outputs, two mesh dimensions)."""
    stages = world["trinv"]["stages"]
    for stage in ("sygst", "phase4", "sytrd", "stedc", "back", "refine"):
        assert stages.get(stage, 0) > 0, (stage, stages)
    assert world["trinv"]["calls"]["reduce_scatter"] == 1
    assert world["two_stage"]["stages"]["sbrd"] > 0
    for name in ("dp", "dp_two_stage_mixed"):
        assert world[name]["stages"] == {"dp": 6}
    assert world["planar_dp"]["stages"] == {"dp": 8}
    # the 3-rank mesh: rows of n = 64 and merges of 32 and 64 do not
    # split, so no stage but the back-transform's 12 columns communicates
    assert set(world["uneven_tp3"]["stages"]) == {"back"}


def test_dp_batch_matches_jax_sygvdx_batched_sharded(world):
    """make_mesh(4, dp=2), batch 4 at n = 32 (JAX's
    test_sygvdx_batched_sharded_dp bars): eigenvalues within 1e-11 of
    scipy's and JAX's, each item's residual < 1e-12."""
    a, b = _batch(random_spd_pair, 4, 32, 40)
    w, z, info = _out(world, "dp")
    jw, _, jinfo = jax_batched_sharded(a, b, jax_mesh(4, dp=2), il=1, iu=4,
                                       cfg=JaxConfig(stedc_leaf=LEAF))
    assert info.tolist() == np.asarray(jinfo).tolist() == [0] * 4
    for k in range(4):
        w_ref = scipy.linalg.eigh(a[k], b[k], eigvals_only=True)[:4]
        assert np.abs(w[k] - w_ref).max() < 1e-11
        assert np.abs(w[k] - np.asarray(jw)[k]).max() < 1e-11
        assert ge_residual(a[k], b[k], w[k], z[k]) < 1e-12


def test_dp_two_stage_mixed_batch_matches_the_unsharded_batch(world):
    """A batch of 8 with the mixed two-stage pipeline (kernels K5, K7, K9
    on each rank's share): every item equals the port's unsharded batched
    solve of the whole batch."""
    a, b = _batch(random_spd_pair, 8, 32, 60)
    w, z, info = _out(world, "dp_two_stage_mixed")
    ref = eig.sygvdx_batched(torch.tensor(a), torch.tensor(b), il=1, iu=4,
                             cfg=_cfg(tridiag_mode="two", band=8, **MIXED))
    assert info.tolist() == ref.info.tolist() == [0] * 8
    for k in range(8):
        _check_solve(a[k], b[k], w[k], z[k], info[k], 1, 4)
        assert np.abs(w[k] - ref.w[k].numpy()).max() < 1e-12 * 32
        assert compare_vectors(z[k], ref.z[k].numpy()) < 1e-8


def test_planar_dp_batch_matches_jax_zhegvdx_planar_batched_sharded(world):
    """make_mesh(4, dp=2), 8 x n = 48 planar (JAX's
    test_zhegvdx_planar_batched_sharded bars: 1e-10 n of scipy), and the
    same of JAX's sharded result."""
    a, b = _batch(random_hpd_pair, 8, 48, 100)
    w, zr, zi, info = _out(world, "planar_dp")
    jw, _, _, jinfo = jax_planar_sharded(*_planes(a, b), jax_mesh(4, dp=2), il=1, iu=6,
                                         cfg=JaxConfig(stedc_leaf=LEAF))
    assert info.tolist() == np.asarray(jinfo).tolist() == [0] * 8
    for k in range(8):
        want = scipy.linalg.eigh(a[k], b[k], eigvals_only=True)[:6]
        assert np.abs(w[k] - want).max() < 1e-10 * 48
        assert np.abs(w[k] - np.asarray(jw)[k]).max() < 1e-10 * 48
        assert ge_residual(a[k], b[k], w[k], zr[k] + 1j * zi[k]) < 1e-12


@pytest.mark.parametrize("name,chunk", [("planar_dp_chunk", 4), ("planar_dp_two_stage", None)])
def test_planar_dp_batch_matches_the_unsharded_batch(world, name, chunk):
    """``chunk=4`` of the global batch (one item a rank at a time) in
    ``mp``, and the mixed two-stage planar batch on a 4-rank 'tp' mesh
    (the batch splits over both dimensions): each item equals the port's
    unsharded batched solve."""
    a, b = _batch(random_hpd_pair, 8, 48, 100)
    kw = CASES[name][2]
    w, zr, zi, info = _out(world, name)
    ref = eig.zhegvdx_planar_batched(*(torch.tensor(x) for x in _planes(a, b)), il=1, iu=6,
                                     cfg=kw["cfg"], chunk=chunk)
    assert info.tolist() == ref.info.tolist() == [0] * 8
    for k in range(8):
        z = zr[k] + 1j * zi[k]
        assert np.abs(w[k] - ref.w[k].numpy()).max() < 1e-12 * 48
        assert compare_vectors(z, ref.zr[k].numpy() + 1j * ref.zi[k].numpy()) < 1e-8
        assert ge_residual(a[k], b[k], w[k], z) < 1e-12


def test_batch_and_chunk_divisibility_raise_jax_errors(world):
    assert world["batch_not_divisible"]["error"] == \
        "ValueError: batch 3 not divisible by 4 devices"
    assert world["planar_batch_not_divisible"]["error"] == \
        "ValueError: batch 3 not divisible by 4 devices"
    assert world["planar_chunk_not_divisible"]["error"] == \
        "ValueError: chunk 2 not divisible by 4 devices"


@pytest.mark.parametrize("name", ["stedc", "stedc_deflation"])
def test_stedc_under_a_mesh_matches_jax_with_the_full_assembly(world, name):
    """stedc(mesh=make_mesh(4)) at n = 100, leaf 16, against JAX's
    ``stedc(mesh=make_mesh(4))``: no compact merge ran (JAX passes
    ``compact=mesh is None``), the top merges communicated, every rank ran
    the same secular sweeps (the stop test is an all_reduce of the ranks'
    done flags, and the deflation mask it reads is the same on every rank),
    and the bars of tests/test_torch_stedc_compact.py against JAX."""
    d, e = CASES[name][1]
    n = d.shape[0]
    w, q, n_compact, sweeps = _out(world, name)
    assert int(n_compact) == 0
    assert len(sweeps) == WORLD and sweeps[0], sweeps
    assert all(s == sweeps[0] for s in sweeps), sweeps
    assert world[name]["stages"]["stedc"] > 0
    jw, jq = jax_stedc(d, e, leaf=LEAF, mesh=jax_mesh(4))
    jw, jq = np.asarray(jw), np.asarray(jq)
    scale = max(np.abs(jw).max(), 1.0)
    assert np.abs(w - jw).max() < 1e-12 * scale * n
    if np.diff(jw).min() > 1e-6 * scale:
        assert compare_vectors(q, jq) < 1e-8
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    res = lambda w, q: np.abs(t @ q - q * w).max()
    assert res(w, q) < 4 * res(jw, jq) + 1e-13 * scale * n
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-11 * n


def test_refine_eigh_ozaki_under_a_mesh_is_the_native_route(world):
    """JAX's gate: ozaki only without a mesh, so under one the refinement
    takes the plain product, bit for bit the native route's, and splits it
    over the ranks."""
    wn, xn = _out(world, "refine_native")
    wo, xo = _out(world, "refine_ozaki")
    assert np.array_equal(wn, wo) and np.array_equal(xn, xo)
    assert world["refine_ozaki"]["stages"]["refine"] > 0
    a, _ = _refine_inputs()
    w_ref, v_ref = np.linalg.eigh(a)
    assert np.abs(wn - w_ref[:24]).max() < 1e-12 * 64
    assert compare_vectors(xn, v_ref[:, :24]) < 1e-8
