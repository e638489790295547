"""``zhegvdx_planar_batched`` (eigensolver_gpu_torch) against the JAX
package's ``zhegvdx_planar_batched`` (jax.vmap of its planar driver), on
the CPU: a batch of 3 at n = 32, il = 1 .. iu = 8, in the modes ``mp``
(fp32 pipeline + fp64 refinement) and fp64, with ``chunk`` None and 1;
each item also against the port's unbatched solve of it, and the edge
cases: a non-positive-definite B in one item, ``chunk`` that does not
divide the batch, batch 1, ``use_pallas=True`` (which ran item by item
before its kernels took a batch) and the batched two-stage solve
(``tridiag_mode='two'``). The bars are JAX's own
(tests/test_batched.py): eigenvalues within 1e-10 n of JAX and of scipy,
``ge_residual`` < 1e-12, ``info`` exact.

The JAX reference is its fp64 batched solve, for the port's ``mp`` and
fp64 modes alike: compiling jax.vmap of JAX's mixed driver (its ozaki
refinement graph) took most of this file's time, and an ``mp`` solve is
held to fp64 accuracy by the same bars (1e-10 n on the eigenvalues, info
exact: the fp32 and the fp64 Cholesky fail at the same pivot here). Each
``mp`` item stays held to the port's own unbatched ``mp`` solve."""

import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_batched as jax_batched
import eigensolver_gpu_torch as eig
from test_torch_batched_helpers import (
    LEAF,
    MIXED,
    MODES,
    as_complex,
    check_against_single,
    check_items,
    pair_batch,
    planar_single,
    planes,
)

torch.set_num_threads(2)

BATCH, N, IU = 3, 32, 8


def _batches():
    a, b = pair_batch(BATCH, N, seed=100)
    bad = b.copy()
    bad[1, 9, 9] = -50.0  # item 1 not positive definite: devInfo column 10
    return {"pd": (a, b), "non_pd": (a, bad)}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's fp64 results of both batches (one compile), the reference of
    both modes (module docstring)."""
    out = {}
    for name, (a, b) in _batches().items():
        w, zr, zi, info = jax_batched(a.real, a.imag, b.real, b.imag, il=1, iu=IU,
                                      cfg=JaxConfig(stedc_leaf=LEAF, **MODES["fp64"]))
        out[name] = (np.asarray(w), np.asarray(zr) + 1j * np.asarray(zi), np.asarray(info))
    return out


@pytest.mark.parametrize("chunk", [None, 1])
@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_batched_matches_jax_and_each_unbatched_solve(jax_ref, mode, chunk):
    a, b = _batches()["pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **MODES[mode])
    res = eig.zhegvdx_planar_batched(*planes(a, b), il=1, iu=IU, cfg=cfg, chunk=chunk)
    assert isinstance(res, eig.PlanarResult)
    assert res.w.shape == (BATCH, IU) and res.zr.shape == res.zi.shape == (BATCH, N, IU)
    assert res.w.dtype == res.zr.dtype == torch.float64 and res.info.dtype == torch.int32
    w, z = res.w.numpy(), as_complex(res.zr, res.zi)
    jw, jz, jinfo = jax_ref["pd"]
    check_items(a, b, w, z, res.info.numpy(), IU, jw=jw, jinfo=jinfo)
    for k in range(BATCH):
        sw, sz, sinfo = planar_single(a[k], b[k], IU, cfg)
        assert sinfo == 0
        check_against_single(w[k], z[k], (sw, sz), N)


@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_non_pd_item_sets_its_own_info(jax_ref, mode):
    """Item 1's B has a negative pivot at row 10: its info is 10, as in
    jax.vmap of the JAX driver (fp64) and in the port's unbatched solve, with no
    exception; items 0 and 2 are as in the all-PD batch."""
    a, bad = _batches()["non_pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **MODES[mode])
    res = eig.zhegvdx_planar_batched(*planes(a, bad), il=1, iu=IU, cfg=cfg)
    jw, _, jinfo = jax_ref["non_pd"]
    assert res.info.numpy().tolist() == jinfo.tolist() == [0, 10, 0]
    assert planar_single(a[1], bad[1], IU, cfg)[2] == 10
    w, z = res.w.numpy(), as_complex(res.zr, res.zi)
    check_items(a, bad, w, z, res.info.numpy(), IU, jw=jw, skip=(1,))
    good = eig.zhegvdx_planar_batched(*planes(*_batches()["pd"]), il=1, iu=IU, cfg=cfg)
    gz = as_complex(good.zr, good.zi)
    for k in (0, 2):
        check_against_single(w[k], z[k], (good.w[k].numpy(), gz[k]), N)


def test_chunk_must_divide_the_batch():
    a, b = _batches()["pd"]
    with pytest.raises(ValueError, match="batch 3 not divisible by chunk 2"):
        eig.zhegvdx_planar_batched(*planes(a, b), il=1, iu=IU, chunk=2)
    with pytest.raises(ValueError):
        eig.zhegvdx_planar_batched(*(x[0] for x in planes(a, b)), il=1, iu=IU)


@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_batch_of_one_equals_the_unbatched_solve(mode):
    a, b = _batches()["pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **MODES[mode])
    res = eig.zhegvdx_planar_batched(*(x[:1] for x in planes(a, b)), il=1, iu=IU, cfg=cfg)
    one = eig.zhegvdx_planar(*(x[0] for x in planes(a, b)), il=1, iu=IU, cfg=cfg)
    assert res.w.shape == (1, IU) and res.info.shape == (1,)
    check_against_single(res.w[0].numpy(), as_complex(res.zr[0], res.zi[0]),
                         (one.w.numpy(), as_complex(one.zr, one.zi)), N)
    assert int(res.info[0]) == int(one.info) == 0


@pytest.mark.parametrize("kw", [dict(MIXED, use_pallas=True), dict(tridiag_mode="two", band=8)])
def test_item_by_item_configurations_equal_the_unbatched_solves(monkeypatch, kw):
    """Named for the item-by-item route that use_pallas=True took before K2
    took a batch. Both configurations now run one batched solve: no
    unbatched zhegvdx_planar call (use_pallas=True, mp: the mixed driver
    and its fp32 inner solve, each once on the whole batch; at n = 32 no
    bucket reaches K2, which tests/test_torch_batched_pallas.py drives);
    with tridiag_mode='two' one call of the K6 wrapper a psbrd panel and
    one of the K8 and the K10 wrappers, each on the whole batch. Each item
    equals its unbatched solve to the module's tolerance
    (check_against_single)."""
    import eigensolver_gpu_torch.models.zhegvdx_planar as zp
    from eigensolver_gpu_torch.ops import chase, ql_panel, replay

    a, b = _batches()["pd"]
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **kw)
    calls = []
    real = zp.zhegvdx_planar
    monkeypatch.setattr(zp, "zhegvdx_planar",
                        lambda *args, **k: calls.append(args[0].dim()) or real(*args, **k))
    wrapped = {}

    def logged(mod, name, shape_of):
        """Wrap mod.name to log the shape it is given (shape_of(args))."""
        fn, log = getattr(mod, name), wrapped.setdefault(name, [])
        monkeypatch.setattr(mod, name, lambda *args, **k: log.append(shape_of(args))
                            or fn(*args, **k))

    logged(ql_panel, "ql_panel_planar", lambda args: tuple(args[0].shape))
    logged(chase, "bulge_chase_planar_kernel", lambda args: tuple(args[0].shape))
    logged(replay, "apply_q2_planar_kernel", lambda args: tuple(args[2][0].shape))
    res = eig.zhegvdx_planar_batched(*planes(a, b), il=1, iu=IU, cfg=cfg)
    monkeypatch.undo()
    if kw.get("use_pallas"):
        assert calls == [3, 3]  # one batched mixed solve and its batched fp32 inner solve
        assert not any(wrapped.values())
    else:
        assert calls == [3]  # one batched solve
        assert [s[0] for s in wrapped["ql_panel_planar"]] == [BATCH] * (N // 8 - 1)
        assert wrapped["bulge_chase_planar_kernel"] == [(BATCH, N, 16)]
        assert wrapped["apply_q2_planar_kernel"] == [(BATCH, N, IU)]
    for k in range(BATCH):
        sw, sz, sinfo = planar_single(a[k], b[k], IU, cfg)
        assert sinfo == int(res.info[k]) == 0
        check_against_single(res.w[k].numpy(), as_complex(res.zr[k], res.zi[k]), (sw, sz), N)
    check_items(a, b, res.w.numpy(), as_complex(res.zr, res.zi), res.info.numpy(), IU)
