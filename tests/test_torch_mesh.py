"""The port's meshes and collectives (eigensolver_gpu_torch/parallel/mesh.py,
parallel/comm.py) and its sharded solves in a gloo world of two CPU
ranks, and the multi-chip dry run in a world of four.

The two-rank world is one module fixture (``run_calls`` of
parallel/dryrun.py, so the ranks import neither JAX nor this file):
``make_mesh`` against the JAX function's shape and error messages, each
collective on rank-made data, and a tp = 2 and a dp = 2 solve against the
port's unsharded solve (eigenvalues within 1e-12 n, vectors within 1e-8
phase-insensitively, ``ge_residual`` < 1e-12). ``dryrun_multichip(4)`` is
the twin of JAX's ``dryrun_multichip``: its five checks at n = 64 with
``info == 0`` everywhere.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from eigensolver_gpu_tpu.parallel import make_mesh as jax_mesh
import eigensolver_gpu_torch as eig
import eigensolver_gpu_torch.parallel as par
from eigensolver_gpu_torch.parallel.dryrun import dryrun_multichip, run_calls, run_world
from eigensolver_gpu_torch.utils.testing import compare_vectors, ge_residual, random_spd_pair

torch.set_num_threads(2)

WORLD = 2
CPU = dict(device_type="cpu")
TWO = dict(stedc_leaf=16, tridiag_mode="two", band=8)
MIXED = dict(compute_dtype="float32", refine_iters=2)

CASES = {
    "mesh_default": ("make_mesh", (), CPU, None),
    "mesh_dp2": ("make_mesh", (2,), dict(dp=2, **CPU), None),
    "mesh_one": ("make_mesh", (1,), CPU, None),
    "mesh_too_many": ("make_mesh", (3,), CPU, None),
    "mesh_dp_not_dividing": ("make_mesh", (2,), dict(dp=3, **CPU), None),
    "collectives": ("collectives", (), {}, (2, 1)),
    "collectives_dp": ("collectives", (), {}, (2, 2)),
    "tp2_two_stage_mixed": ("sygvdx_sharded", random_spd_pair(64, seed=40),
                            dict(il=3, iu=18, cfg=eig.SolverConfig(**TWO, **MIXED)), (2, 1)),
    "tp2_fp64": ("sygvdx_sharded", random_spd_pair(64, seed=41),
                 dict(il=1, iu=16, cfg=eig.SolverConfig(stedc_leaf=16)), (2, 1)),
    "dp2": ("sygvdx_batched_sharded",
            tuple(np.stack(x) for x in zip(*(random_spd_pair(32, seed=50 + k) for k in range(4)))),
            dict(il=1, iu=4, cfg=eig.SolverConfig(**TWO)), (2, 2)),
}


@pytest.fixture(scope="module")
def world():
    """Every case in one world of two gloo ranks: name -> rank 0's record."""
    names = list(CASES)
    return dict(zip(names, run_world(WORLD, run_calls, ([CASES[k] for k in names],))))


def test_parallel_exports_the_jax_names():
    import eigensolver_gpu_tpu.parallel as jax_par

    assert sorted(par.__all__) == sorted(jax_par.__all__)
    for name in par.__all__:
        assert callable(getattr(par, name))
    with pytest.raises(AttributeError):
        par.not_a_name  # noqa: B018


def test_make_mesh_shapes_match_jax(world):
    assert world["mesh_default"]["out"] == (1, 2)
    assert world["mesh_dp2"]["out"] == (2, 1)
    assert world["mesh_one"]["out"] == (1, 1)
    assert jax_mesh(2, dp=2).devices.shape == (2, 1)
    assert jax_mesh(2).axis_names == ("dp", "tp")


def test_make_mesh_raises_jax_errors(world):
    assert world["mesh_too_many"]["error"] == "ValueError: requested 3 devices, have 2"
    assert world["mesh_dp_not_dividing"]["error"] == \
        "ValueError: n_devices=2 not divisible by dp=3"
    with pytest.raises(ValueError, match="n_devices=2 not divisible by dp=3"):
        jax_mesh(2, dp=3)
    with pytest.raises(RuntimeError, match="initialised default process group"):
        par.make_mesh(1, device_type="cpu")


@pytest.mark.parametrize("name", ["collectives", "collectives_dp"])
def test_collectives(world, name):
    """Rank r's tensors hold 100 r + index. On 'tp' of make_mesh(2): the
    gathers concatenate rank 0's and rank 1's blocks, the sums and maxima
    reduce them, reduce_scatter leaves rank 0 the first rows of the sum,
    row_block its first half of an even row count and all of an odd one.
    On make_mesh(2, dp=2) 'tp' has one rank: every collective is rank 0's
    own data."""
    out = world[name]["out"]
    x = np.arange(6.0).reshape(2, 3)
    y = np.arange(24.0).reshape(2, 4, 3)
    if name == "collectives":
        np.testing.assert_array_equal(out[0], np.concatenate([x, x + 100], 0))
        np.testing.assert_array_equal(out[1], np.concatenate([x, x + 100], 1))
        np.testing.assert_array_equal(out[2], 2 * x + 100)
        np.testing.assert_array_equal(out[3], x + 100)
        np.testing.assert_array_equal(out[4], (2 * y + 100)[:, :2])
        np.testing.assert_array_equal(out[5], np.arange(12.0).reshape(4, 3)[:2])
        assert out[7].tolist() == [1, 2, 0]
        assert world[name]["calls"] == {"all_gather": 2, "all_reduce": 2, "reduce_scatter": 1}
    else:
        for got, want in zip(out[:5], (x, x, x, x, y)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out[5], np.arange(12.0).reshape(4, 3))
        assert out[7].tolist() == [2, 1, 0]
    np.testing.assert_array_equal(out[6], np.arange(15.0).reshape(5, 3))


@pytest.mark.parametrize("name", ["tp2_two_stage_mixed", "tp2_fp64"])
def test_tp2_solve_matches_the_unsharded_solve(world, name):
    """make_mesh(2): the mixed two-stage solve (sbrd's rows, stedc's top
    merges, the back-transform's columns and the refinement's rows on two
    ranks) and the fp64 one-stage solve (sytrd's rows) against the port's
    unsharded sygvdx."""
    _, (a, b), kw, _ = CASES[name]
    w, z, info = world[name]["out"]
    ref = eig.sygvdx(torch.tensor(a), torch.tensor(b), **kw)
    assert int(info) == int(ref.info) == 0
    n = a.shape[0]
    assert np.abs(w - ref.w.numpy()).max() < 1e-12 * n
    assert np.abs(w - scipy.linalg.eigh(a, b, eigvals_only=True)[kw["il"] - 1 : kw["iu"]]).max() \
        < 1e-10 * n
    assert compare_vectors(z, ref.z.numpy()) < 1e-8
    assert ge_residual(a, b, w, z) < 1e-12
    stages = world[name]["stages"]
    assert stages["stedc"] > 0 and stages["back"] > 0
    assert stages["sbrd" if "two" in name else "sytrd"] > 0


def test_dp2_batch_matches_the_unsharded_batch(world):
    """make_mesh(2, dp=2): each rank solves two of the four items with the
    two-stage batched driver, then the outputs are gathered."""
    _, (a, b), kw, _ = CASES["dp2"]
    w, z, info = world["dp2"]["out"]
    ref = eig.sygvdx_batched(torch.tensor(a), torch.tensor(b), **kw)
    assert info.tolist() == ref.info.tolist() == [0] * 4
    for k in range(4):
        assert np.abs(w[k] - ref.w[k].numpy()).max() < 1e-12 * 32
        assert compare_vectors(z[k], ref.z[k].numpy()) < 1e-8
        assert ge_residual(a[k], b[k], w[k], z[k]) < 1e-12
    assert world["dp2"]["stages"] == {"dp": 6}


def test_dryrun_multichip_four_ranks():
    """JAX's five dry-run checks in a world of four gloo ranks (dp = 2):
    every info is 0."""
    infos = dryrun_multichip(4)
    assert infos == {"tp": 0, "dp": [0] * 4, "planar": 0, "planar dp": [0] * 4,
                     "tp two-stage": 0}
