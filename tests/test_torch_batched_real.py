"""``parallel.sharded.sygvdx_batched`` (eigensolver_gpu_torch) against the
JAX package's (jax.vmap of its ``sygvdx``), on the CPU: a batch of 3 at
n = 32, il = 1 .. iu = 8, real in fp64 and in ``mp``, and complex in fp64;
each item also against the port's unbatched ``sygvdx`` of it, a
non-positive-definite B in one item, ``use_pallas=True`` (which ran item
by item before K4 took a batch) and the batched two-stage solve
(``tridiag_mode='two'``). Bars as JAX's own
tests/test_batched.py: eigenvalues within 1e-10 n of JAX and of scipy,
``ge_residual`` < 1e-12, ``info`` exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.parallel.sharded import sygvdx_batched as jax_batched
import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.parallel import sygvdx_batched
from test_torch_batched_helpers import (
    LEAF,
    MIXED,
    MODES,
    check_against_single,
    check_items,
    pair_batch,
)

torch.set_num_threads(2)

BATCH, N, IU = 3, 32, 8
CASES = {"real-fp64": (False, "fp64"), "real-mp": (False, "mp"), "complex-fp64": (True, "fp64")}


def _single(a, b, cfg):
    res = eig.sygvdx(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU, cfg=cfg)
    return res.w.numpy(), res.z.resolve_conj().numpy(), int(res.info)


@pytest.mark.parametrize("case", list(CASES))
def test_batched_matches_jax_and_each_unbatched_solve(case):
    cplx, mode = CASES[case]
    a, b = pair_batch(BATCH, N, seed=140, cplx=cplx)
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **MODES[mode])
    res = sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU, cfg=cfg)
    assert isinstance(res, eig.SygvdxResult)
    assert res.w.shape == (BATCH, IU) and res.z.shape == (BATCH, N, IU)
    assert res.z.dtype == torch.from_numpy(a).dtype and res.info.dtype == torch.int32
    jw, _, jinfo = jax_batched(jnp.asarray(a), jnp.asarray(b), il=1, iu=IU,
                               cfg=JaxConfig(stedc_leaf=LEAF, **MODES[mode]))
    w, z = res.w.numpy(), res.z.resolve_conj().numpy()
    check_items(a, b, w, z, res.info.numpy(), IU, jw=np.asarray(jw), jinfo=np.asarray(jinfo))
    for k in range(BATCH):
        sw, sz, sinfo = _single(a[k], b[k], cfg)
        assert sinfo == 0
        check_against_single(w[k], z[k], (sw, sz), N)


@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_non_pd_item_sets_its_own_info(mode):
    """Item 1's B has a negative first pivot: its info is 1 as in jax.vmap
    of the JAX driver; with the bad pivot at row 10 it is 10 as in the
    port's unbatched solve (LAPACK's devInfo; the JAX function on the CPU
    reports 1 there, ROADMAP.md C). No exception, and items 0 and 2 are as
    in the all-PD batch."""
    a, b = pair_batch(BATCH, N, seed=150, cplx=False)
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **MODES[mode])
    good = sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU, cfg=cfg)
    for row, want in ((0, 1), (9, 10)):
        bad = b.copy()
        bad[1, row, row] = -50.0
        res = sygvdx_batched(torch.from_numpy(a), torch.from_numpy(bad), il=1, iu=IU, cfg=cfg)
        assert res.info.numpy().tolist() == [0, want, 0]
        assert _single(a[1], bad[1], cfg)[2] == want
        if row == 0:
            jinfo = jax_batched(jnp.asarray(a), jnp.asarray(bad), il=1, iu=IU,
                                cfg=JaxConfig(stedc_leaf=LEAF, **MODES[mode])).info
            assert np.asarray(jinfo).tolist() == [0, 1, 0]
        w, z = res.w.numpy(), res.z.numpy()
        check_items(a, bad, w, z, res.info.numpy(), IU, skip=(1,))
        for k in (0, 2):
            check_against_single(w[k], z[k], (good.w[k].numpy(), good.z[k].numpy()), N)


@pytest.mark.parametrize("kw", [dict(MIXED, use_pallas=True), dict(tridiag_mode="two", band=8)])
def test_item_by_item_configurations_equal_the_unbatched_solves(monkeypatch, kw):
    """Named for the item-by-item route that use_pallas=True took before K4
    took a batch. Both configurations now run one batched solve: the
    solve's body called once, on the whole batch (use_pallas=True at n = 32
    reaches no K4 bucket, which tests/test_torch_batched_pallas.py
    drives); with tridiag_mode='two' one call of the K5 wrapper a sbrd panel
    and one of the K7 and the K9 wrappers, each on the whole batch. Each
    item equals its unbatched solve to the module's tolerance
    (check_against_single)."""
    import eigensolver_gpu_torch.parallel.sharded as sharded
    from eigensolver_gpu_torch.ops import chase, ql_panel, replay

    a, b = pair_batch(BATCH, N, seed=160, cplx=False)
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **kw)
    calls = []
    real = sharded._sygvdx
    monkeypatch.setattr(sharded, "_sygvdx",
                        lambda *args, **k: calls.append(args[0].dim()) or real(*args, **k))
    wrapped = {}

    def logged(mod, name, shape_of):
        """Wrap mod.name to log the shape it is given (shape_of(args))."""
        fn, log = getattr(mod, name), wrapped.setdefault(name, [])
        monkeypatch.setattr(mod, name, lambda *args, **k: log.append(shape_of(args))
                            or fn(*args, **k))

    logged(ql_panel, "ql_panel", lambda args: tuple(args[0].shape))
    logged(chase, "bulge_chase_kernel", lambda args: tuple(args[0].shape))
    logged(replay, "apply_q2_kernel", lambda args: tuple(args[2].shape))
    res = sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b), il=1, iu=IU, cfg=cfg)
    monkeypatch.undo()
    assert calls == [3]  # one batched solve
    if kw.get("use_pallas"):
        assert not any(wrapped.values())
    else:
        assert [s[0] for s in wrapped["ql_panel"]] == [BATCH] * (N // 8 - 1)
        assert wrapped["bulge_chase_kernel"] == [(BATCH, N, 16)]
        assert wrapped["apply_q2_kernel"] == [(BATCH, N, IU)]
    for k in range(BATCH):
        sw, sz, sinfo = _single(a[k], b[k], cfg)
        assert sinfo == int(res.info[k]) == 0
        check_against_single(res.w[k].numpy(), res.z[k].numpy(), (sw, sz), N)
    check_items(a, b, res.w.numpy(), res.z.numpy(), res.info.numpy(), IU)


def test_shape_checks():
    a, b = pair_batch(2, 16, seed=170, cplx=False)
    with pytest.raises(ValueError):
        sygvdx_batched(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    with pytest.raises(ValueError):
        sygvdx_batched(torch.from_numpy(a), torch.from_numpy(b[:1]))
