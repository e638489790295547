"""``zhegvdx_planar_batched`` at batch 4, n = 64, il = 1 .. iu = 8 against
the JAX package's, on the CPU, in the modes ``mp`` and fp64, with
``chunk`` None, 1 and 2 (JAX's own chunked path, lax.map over vmap, at
chunk 2): eigenvalues within 1e-10 n of JAX and of scipy,
``ge_residual`` < 1e-12, ``info`` exact, and each item against the
port's unbatched solve of it (eigenvalues within 1e-12 n).

The JAX reference of both modes is its fp64 batched solve at the same
``chunk``: compiling jax.vmap of JAX's mixed driver took most of this
file's time, and an ``mp`` solve is held to fp64 accuracy by the same
bars; each ``mp`` item stays held to the port's own unbatched ``mp``
solve."""

import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu import SolverConfig as JaxConfig
from eigensolver_gpu_tpu.models.zhegvdx_planar import zhegvdx_planar_batched as jax_batched
import eigensolver_gpu_torch as eig
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

torch.set_num_threads(2)

BATCH, N, IU = 4, 64, 8


@pytest.fixture(scope="module")
def case():
    a, b = pair_batch(BATCH, N, seed=120)
    singles = {mode: [planar_single(a[k], b[k], IU, eig.SolverConfig(stedc_leaf=LEAF, **kw))
                      for k in range(BATCH)]
               for mode, kw in MODES.items()}
    return a, b, singles


@pytest.mark.parametrize("chunk", [None, 1, 2])
@pytest.mark.parametrize("mode", ["mp", "fp64"])
def test_chunks_match_jax_and_each_unbatched_solve(case, mode, chunk):
    a, b, singles = case
    cfg = eig.SolverConfig(stedc_leaf=LEAF, **MODES[mode])
    res = eig.zhegvdx_planar_batched(*planes(a, b), il=1, iu=IU, cfg=cfg, chunk=chunk)
    assert res.w.shape == (BATCH, IU) and res.zr.shape == (BATCH, N, IU)
    assert res.info.shape == (BATCH,)
    jw = jinfo = None
    if chunk in (None, 2):
        jw, _, _, jinfo = jax_batched(a.real, a.imag, b.real, b.imag, il=1, iu=IU,
                                      cfg=JaxConfig(stedc_leaf=LEAF, **MODES["fp64"]),
                                      chunk=chunk)
    w, z = res.w.numpy(), as_complex(res.zr, res.zi)
    check_items(a, b, w, z, res.info.numpy(), IU, jw=jw, jinfo=jinfo)
    for k in range(BATCH):
        sw, sz, sinfo = singles[mode][k]
        assert sinfo == 0
        check_against_single(w[k], z[k], (sw, sz), N)
