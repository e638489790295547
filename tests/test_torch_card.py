"""The port's kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU with nvcc; skips with a reason elsewhere. Imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_card.py --noconftest -m cuda -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)
"""

import numpy as np
import pytest
import torch

from eigensolver_gpu_torch.ops.latrd import latrd_panel_plain, latrd_panel_planar
from eigensolver_gpu_torch.ops.pchol import pchol_block_plain, pchol_block_planar

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _planes(x, dev):
    return torch.tensor(x.real, dtype=torch.float32, device=dev), torch.tensor(
        x.imag, dtype=torch.float32, device=dev
    )


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [32, 100, 128])
def test_pchol_block_kernel_matches_plain(cuda_device, nb):
    """K1 within 1e-4 relative (Frobenius) of its plain version, fail exact,
    also past a bad pivot."""
    rng = np.random.default_rng(nb)
    t = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    a = t @ t.conj().T + nb * np.eye(nb)
    for bad in (None, 7):
        if bad is not None:
            a[bad, bad] = -1e4
        dr, di = _planes(a, cuda_device)
        before = pchol_block_planar.launches
        got = pchol_block_planar(dr, di)
        want = pchol_block_plain(dr, di)
        assert pchol_block_planar.launches == before + 1
        assert int(got[4]) == int(want[4]) == (0 if bad is None else bad + 1)
        cols = nb if bad is None else bad
        for g, w in zip(got[:2], want[:2]):
            g, w = g[:, :cols].cpu(), w[:, :cols].cpu()
            assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("pe_off", [0, 64, None])
def test_latrd_panel_kernel_matches_plain(cuda_device, pe_off):
    """K2 within rtol 1e-4 / atol 1e-3 of its plain version (fp32 sums in
    another order), on a bucket view whose row stride exceeds mb."""
    n, mb = 640, 512
    rng = np.random.default_rng(7)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    ar, ai = _planes((t + t.conj().T) / 2, cuda_device)
    ar, ai = ar[:mb, :mb], ai[:mb, :mb]
    pe = 32 if pe_off is None else mb - pe_off
    got = latrd_panel_planar(ar, ai, pe)
    want = latrd_panel_plain(ar, ai, pe)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, atol=1e-3)
