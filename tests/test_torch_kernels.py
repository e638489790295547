"""The port's two kernels (eigensolver_gpu_torch/ops/pchol.py, K1, and
ops/latrd.py, K2) against the Pallas kernels they replace.

On the CPU the wrappers take their plain PyTorch versions; the JAX side
runs the Pallas kernels in interpret mode, as tests/test_pchol_pallas.py
and tests/test_latrd_pallas.py do. The same numpy inputs, made from a
seed, go to both. The kernel-vs-plain comparison on the card is in
tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigensolver_gpu_tpu.ops.latrd_pallas import latrd_panel_planar as jax_latrd
from eigensolver_gpu_tpu.ops.pchol_pallas import pchol_block_planar_pallas
from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
from eigensolver_gpu_torch.ops.pchol import pchol_block_planar

torch.set_num_threads(2)


def _hpd_block(nb, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    a = t @ t.conj().T + nb * np.eye(nb)
    return np.real(a).astype(np.float32), np.imag(a).astype(np.float32)


def _hermitian_planes(mb, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((mb, mb)) + 1j * rng.standard_normal((mb, mb))
    a = (t + t.conj().T) / 2
    return a.real.astype(np.float32), a.imag.astype(np.float32)


def _frob_rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("nb", [8, 32, 128])
def test_pchol_block_matches_pallas(nb):
    """L and inv(L) within 1e-4 relative (Frobenius): fp32, sums taken in
    another order; fail exact."""
    ar, ai = _hpd_block(nb, nb)
    want = pchol_block_planar_pallas(jnp.asarray(ar), jnp.asarray(ai), interpret=True)
    got = pchol_block_planar(torch.from_numpy(ar), torch.from_numpy(ai))
    for g, w in zip(got[:4], want[:4]):
        assert _frob_rel(g.numpy(), w) < 1e-4
    assert int(got[4]) == int(want[4]) == 0
    assert got[4].dtype == torch.int32


@pytest.mark.parametrize("bad", [0, 5, 31])
def test_pchol_block_fail_contract(bad):
    """A non-HPD block: the 1-based first bad pivot matches the Pallas
    kernel's exactly. The factor past a bad pivot is undefined (the
    Pallas kernel's masked writes turn it NaN throughout); here the
    leading block stays the Cholesky factor of the leading HPD block."""
    nb = 32
    ar, ai = _hpd_block(nb, 3)
    ar[bad, bad] = -1e4
    want = pchol_block_planar_pallas(jnp.asarray(ar), jnp.asarray(ai), interpret=True)
    got = pchol_block_planar(torch.from_numpy(ar), torch.from_numpy(ai))
    assert int(got[4]) == int(want[4]) == bad + 1
    if bad > 0:
        lead = (ar + 1j * ai).astype(np.complex128)[:bad, :bad]
        l_ref = np.linalg.cholesky(lead)
        l_got = got[0].numpy()[:bad, :bad] + 1j * got[1].numpy()[:bad, :bad]
        assert _frob_rel(l_got, l_ref) < 1e-4


@pytest.mark.parametrize("value", [4.0, -1.0])
def test_pchol_block_takes_a_one_by_one_block_of_any_strides(value):
    """numpy's ``.real`` of a 1 x 1 complex array keeps strides of two
    floats; the wrapper takes it (the Pallas kernel needs nb % 8 == 0, so
    the reference is the scalar factor: L = sqrt(a), inv = 1 / L)."""
    a = np.array([[value + 0j]])
    dr = torch.tensor(a.real, dtype=torch.float32)
    assert dr.stride() != (1, 1)
    got = pchol_block_planar(dr, torch.tensor(a.imag, dtype=torch.float32))
    assert int(got[4]) == (0 if value > 0 else 1)
    if value > 0:
        want = (np.sqrt(value), 0.0, 1 / np.sqrt(value), 0.0)
        for g, w in zip(got[:4], want):
            assert g.shape == (1, 1) and abs(float(g) - w) <= 1e-6 * max(abs(w), 1)


def test_pchol_block_nan_pivot():
    nb = 8
    ar, ai = _hpd_block(nb, 4)
    ar[2, 2] = np.nan
    want = pchol_block_planar_pallas(jnp.asarray(ar), jnp.asarray(ai), interpret=True)
    got = pchol_block_planar(torch.from_numpy(ar), torch.from_numpy(ai))
    assert int(got[4]) == int(want[4]) == 3


@pytest.mark.parametrize("pe", [256, 224, 32])
def test_latrd_panel_matches_pallas(pe):
    """Every output within rtol 1e-4 / atol 1e-3: fp32 on O(15) data with
    rank-2 accumulation in another summation order (the tolerance of
    tests/test_planar_pipeline.py's Pallas-path check)."""
    mb, nb = 256, 32
    ar, ai = _hermitian_planes(mb, 5)
    want = jax_latrd(jnp.asarray(ar), jnp.asarray(ai), pe, nb=nb, tile=64, interpret=True)
    got = latrd_panel_planar(torch.from_numpy(ar), torch.from_numpy(ai), pe, nb=nb)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)


def test_latrd_panel_leaves_input_and_counts_nothing_on_cpu():
    mb = 256
    ar, ai = _hermitian_planes(mb, 6)
    tr, ti = torch.from_numpy(ar.copy()), torch.from_numpy(ai.copy())
    before = latrd_panel_planar.launches
    latrd_panel_planar(tr, ti, mb)
    assert latrd_panel_planar.launches == before
    assert np.array_equal(tr.numpy(), ar) and np.array_equal(ti.numpy(), ai)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        pchol_block_planar(z, z)
    with pytest.raises(ValueError):
        pchol_block_planar(torch.zeros((129, 129)), torch.zeros((129, 129)))
    with pytest.raises(ValueError):
        latrd_panel_planar(torch.zeros((64, 64)), torch.zeros((64, 64)), 16, nb=32)
