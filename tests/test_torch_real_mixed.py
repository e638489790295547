"""The port's mixed-precision real drivers (fp64 operands,
``SolverConfig(compute_dtype="float32")``: fp32 pipeline, fp64 refinement
of the selected block plus its margin) against the JAX package's, on the
CPU.

Kept apart from tests/test_torch_real_pipeline.py because each JAX
mixed-mode driver takes about 20 s to compile on a CPU. The port-only cases
hold the mixed result to scipy at sizes where the JAX side would take
too long (n = 512 with ``use_pallas=True``, the symv branch).
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import eigensolver_gpu_torch as eig
from eigensolver_gpu_torch.utils.testing import ge_residual
from test_torch_real_helpers import check_against_jax, make_pair

torch.set_num_threads(2)

_MIXED = dict(compute_dtype="float32")

_CASES = {
    # name: (driver, n, dtype, config, il, iu)
    "dsygvdx_odd_padding": ("dsygvdx", 96, np.float64, _MIXED, 1, 12),
    "syevdx_interior_range": ("syevdx", 128, np.float64, _MIXED, 40, 71),
    "dsygvdx_two_stage": ("dsygvdx", 128, np.float64, dict(tridiag_mode="two", **_MIXED), 1, 16),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_mixed_driver_matches_jax(case):
    """fp64 tolerances: the refinement recovers fp64 accuracy in both
    packages, so the results agree as the pure-fp64 ones do."""
    check_against_jax(*_CASES[case])


@pytest.mark.parametrize(
    "n,il,iu,kw",
    [
        (256, 1, 32, {}),
        (256, 200, 256, dict(refine_margin=8)),
        (512, 1, 64, dict(use_pallas=True)),
    ],
)
def test_mixed_dsygvdx_reaches_fp64_accuracy(n, il, iu, kw):
    """Eigenvalues within 1e-11 ||A|| of LAPACK's, ge_residual < 1e-12,
    fp64 results of the selected shape."""
    a, b = make_pair(n, np.float64, seed=73)
    res = eig.dsygvdx(a, b, il=il, iu=iu, cfg=eig.SolverConfig(**_MIXED, **kw), device="cpu")
    w, z = res.w.numpy(), res.z.numpy()
    assert int(res.info) == 0
    assert w.dtype == z.dtype == np.float64
    assert w.shape == (iu - il + 1,) and z.shape == (n, iu - il + 1)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_ref[il - 1 : iu]).max() < 1e-11 * np.abs(w_ref).max()
    assert ge_residual(a, b, w, z) < 1e-12
    assert np.abs(z.T @ b @ z - np.eye(iu - il + 1)).max() < 1e-12
