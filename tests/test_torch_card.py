"""The port's kernels (K1..K10) against their plain PyTorch versions on the
card.

Needs an NVIDIA GPU with nvcc; skips with a reason elsewhere. Imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_card.py --noconftest -m cuda -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)
"""

import numpy as np
import pytest
import torch

from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel, bulge_chase_planar_kernel
from eigensolver_gpu_torch.ops.latrd import latrd_panel_plain, latrd_panel_planar
from eigensolver_gpu_torch.ops.pchol import pchol_block_plain, pchol_block_planar
from eigensolver_gpu_torch.ops.ql_panel import (
    ql_panel,
    ql_panel_plain,
    ql_panel_planar,
    ql_panel_planar_plain,
)
from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, apply_q2_planar_kernel
from eigensolver_gpu_torch.ops.sb2st import apply_q2, bulge_chase, dense_to_band
from eigensolver_gpu_torch.ops.sb2st_planar import (
    apply_q2_planar,
    bulge_chase_planar,
    phase_normalize,
)
from eigensolver_gpu_torch.ops.symv import hemv_planar, hemv_planar_plain, symv, symv_plain

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


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(512, torch.float32), (1000, torch.float32),
                                     (512, torch.float64)])
def test_symv_and_hemv_kernels_match_plain(cuda_device, n, dtype):
    """K4 (and K3 in fp32) within 1e-4 relative of the plain version in
    fp32 (another summation order), 1e-12 in fp64; reproducible bit for
    bit; on a view whose row stride exceeds n."""
    rng = np.random.default_rng(n)
    t = rng.standard_normal((n + 24, n + 24))
    a, v = (t + t.T) / 2, rng.standard_normal(n + 24)
    ta = torch.tensor(a, dtype=dtype, device=cuda_device)[:n, :n]
    tv = torch.tensor(v[:n], dtype=dtype, device=cuda_device)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    before = symv.launches
    got = symv(ta, tv)
    assert symv.launches == before + 1
    want = symv_plain(ta, tv)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert torch.equal(got, symv(ta, tv))
    if dtype == torch.float32:
        # the antisymmetric plane as a view with ta's row stride
        up = torch.triu(torch.tensor(t, dtype=dtype, device=cuda_device), 1)
        ti = (up - up.T)[:n, :n]
        got = hemv_planar(ta, ti, tv, tv.flip(0))
        want = hemv_planar_plain(ta, ti, tv, tv.flip(0))
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,rb,dtype", [
    (512, 32, 448, torch.float32), (1000, 24, 500, torch.float32),
    (128, 16, 64, torch.float32), (512, 32, 448, torch.float64)])
def test_ql_panel_kernel_matches_plain(cuda_device, m, b, rb, dtype):
    """K5 within 1e-4 relative of its plain version in fp32 (sums in
    another order), 1e-11 in fp64, on a column slice of a wider matrix;
    the trivial-column contract (tau = 0, v = 0, column kept) exactly."""
    rng = np.random.default_rng(m)
    wide = torch.tensor(rng.standard_normal((m, b + 40)), dtype=dtype, device=cuda_device)
    p = wide[:, 11 : 11 + b]
    if m == 128:
        p[: rb + b - 1, b - 1] = 0.0
    before = ql_panel.launches
    got = ql_panel(p, rb)
    assert ql_panel.launches == before + 1
    want = ql_panel_plain(p, rb)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= tol
    if m == 128:
        assert float(got[2][b - 1]) == 0.0 and float(got[1][:, b - 1].abs().max()) == 0.0
        assert torch.equal(got[0][:, b - 1], p[:, b - 1])


def _band(n, b, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n))
    a = (t + t.T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    return a, dense_to_band(torch.tensor(a, dtype=dtype, device=dev), b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,dtype", [(100, 6, torch.float32), (300, 32, torch.float32),
                                       (100, 6, torch.float64), (300, 32, torch.float64)])
def test_chase_kernel_matches_plain(cuda_device, n, b, dtype):
    """K7 against its plain version: d, e, tau and the active reflectors
    within 1e-3 relative in fp32 at these sizes (drift along the dependent
    steps), 1e-9 in fp64; the spectrum kept; two calls bit-identical."""
    a, band = _band(n, b, dtype, cuda_device, n)
    before = bulge_chase_kernel.launches
    got = bulge_chase_kernel(band, b)
    assert bulge_chase_kernel.launches == before + 1
    want = bulge_chase(band, b)
    act = (want[3] != 0)[..., None]
    tol = 1e-3 if dtype == torch.float32 else 1e-9
    pairs = [(got[0], want[0]), (got[1].abs(), want[1].abs()),
             ((got[2] * act).abs(), (want[2] * act).abs()), (got[3], want[3])]
    for g, w in pairs:
        assert g.shape == w.shape and _rel(g, w) <= tol
    assert all(torch.equal(x, y) for x, y in zip(got, bulge_chase_kernel(band, b)))
    d, e = got[0].double().cpu().numpy(), got[1].double().cpu().numpy()
    w = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    assert np.abs(w - np.linalg.eigvalsh(a)).max() < (1e-4 if dtype == torch.float32 else 1e-12) \
        * np.abs(a).max() * np.sqrt(n)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,g,m,dtype", [(512, 32, 96, 100, torch.float32),
                                           (300, 8, 24, 70, torch.float32),
                                           (250, 6, 5, 3, torch.float32),
                                           (300, 32, 32, 64, torch.float64)])
def test_replay_kernel_matches_plain(cuda_device, n, b, g, m, dtype):
    """K9 within 1e-4 relative of sb2st.apply_q2 in fp32 (window sums in
    another order), 1e-11 in fp64, on a column slice of a wider y."""
    _, band = _band(n, b, dtype, cuda_device, n + 1)
    _, _, vt, taut = bulge_chase_kernel(band, b)
    rng = np.random.default_rng(m)
    wide = torch.tensor(rng.standard_normal((n, m + 9)), dtype=dtype, device=cuda_device)
    y = wide[:, 4 : 4 + m]
    before = apply_q2_kernel.launches
    got = apply_q2_kernel(vt, taut, y, n, b, g=g)
    assert apply_q2_kernel.launches == before + 1
    want = apply_q2(vt, taut, y, n, b, g=g)
    assert got.shape == want.shape
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-11)
    assert _rel(want, y) > 0.1  # the replay moves y


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,rb,dtype", [
    (512, 32, 448, torch.float32), (1000, 24, 500, torch.float32),
    (128, 16, 64, torch.float32), (512, 32, 448, torch.float64), (200, 64, 100, torch.float64)])
def test_ql_panel_planar_kernel_matches_plain(cuda_device, m, b, rb, dtype):
    """K6 within 1e-4 relative of its plain version in fp32 (sums in another
    order), 1e-11 in fp64, on column slices of wider planes; a trivial column
    (zero tail, real pivot) and a phase-only column (zero tail, complex
    pivot: tau != 0, the pivot rotated to real) exactly as the contract says."""
    rng = np.random.default_rng(m)
    wide_r = torch.tensor(rng.standard_normal((m, b + 40)), dtype=dtype, device=cuda_device)
    wide_i = torch.tensor(rng.standard_normal((m, b + 40)), dtype=dtype, device=cuda_device)
    pr, pi = wide_r[:, 11 : 11 + b], wide_i[:, 11 : 11 + b]
    if m == 128:
        pr[: rb + b - 1, b - 1] = 0.0  # trivial: zero tail, real pivot
        pi[: rb + b, b - 1] = 0.0
        pr[: rb + b - 2, b - 2] = 0.0  # phase only: zero tail, complex pivot
        pi[: rb + b - 2, b - 2] = 0.0
    before = ql_panel_planar.launches
    got = ql_panel_planar(pr, pi, rb)
    assert ql_panel_planar.launches == before + 1
    want = ql_panel_planar_plain(pr, pi, rb)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= tol
    assert all(torch.equal(x, y) for x, y in zip(got, ql_panel_planar(pr, pi, rb)))
    # pivots are real: the imaginary plane is zero on and above them
    for j in range(b):
        assert float(got[1][: rb + j + 1, j].abs().max()) == 0.0
    if m == 128:
        assert float(got[4][b - 1]) == 0.0 == float(got[5][b - 1])
        assert float(got[2][:, b - 1].abs().max()) == 0.0 == float(got[3][:, b - 1].abs().max())
        assert torch.equal(got[0][:, b - 1], pr[:, b - 1])
        top = rb + b - 2
        assert float(got[5][b - 2]) != 0.0 and float(got[2][top, b - 2]) == 1.0
        assert float(got[2][:top, b - 2].abs().max()) == 0.0
        alpha = float(torch.hypot(pr[top, b - 2], pi[top, b - 2]))
        assert abs(abs(float(got[0][top, b - 2])) - alpha) <= 1e-6 * alpha


def _hband(n, b, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (t + t.conj().T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    planes = [dense_to_band(torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=dev), b)
              for x in (a.real, a.imag)]
    return a, planes


def _flat(out):
    d, e, vt, taut = out
    return [d, e[0], e[1], vt[0], vt[1], taut[0], taut[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,dtype", [(100, 6, torch.float32), (300, 32, torch.float32),
                                       (100, 6, torch.float64), (300, 32, torch.float64)])
def test_chase_planar_kernel_matches_plain(cuda_device, n, b, dtype):
    """K8 against its plain version: d, e, tau and the active reflectors
    within 1e-3 relative in fp32 at these sizes (drift along the dependent
    steps), 1e-9 in fp64; the spectrum of (d, |e|) kept; two calls
    bit-identical."""
    a, (band_r, band_i) = _hband(n, b, dtype, cuda_device, n)
    before = bulge_chase_planar_kernel.launches
    got = bulge_chase_planar_kernel(band_r, band_i, b)
    assert bulge_chase_planar_kernel.launches == before + 1
    want = bulge_chase_planar(band_r, band_i, b)
    act = ((want[3][0] != 0) | (want[3][1] != 0))[..., None]
    tol = 1e-3 if dtype == torch.float32 else 1e-9
    g, w = _flat(got), _flat(want)
    for k in (3, 4):
        g[k], w[k] = g[k] * act, w[k] * act
    for x, y in zip(g, w):
        assert x.shape == y.shape and _rel(x, y) <= tol
    assert all(torch.equal(x, y) for x, y in
               zip(_flat(got), _flat(bulge_chase_planar_kernel(band_r, band_i, b))))
    _, e_abs = phase_normalize(*got[1])
    d, e = got[0].double().cpu().numpy(), e_abs.double().cpu().numpy()
    w = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    assert np.abs(w - np.linalg.eigvalsh(a)).max() < (1e-4 if dtype == torch.float32 else 1e-12) \
        * np.abs(a).max() * np.sqrt(n)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,g,m,dtype", [(512, 32, 96, 100, torch.float32),
                                           (300, 8, 24, 70, torch.float32),
                                           (250, 6, 5, 3, torch.float32),
                                           (300, 32, 32, 64, torch.float64)])
def test_replay_planar_kernel_matches_plain(cuda_device, n, b, g, m, dtype):
    """K10 within 1e-4 relative of sb2st_planar.apply_q2_planar in fp32
    (window sums in another order), 1e-11 in fp64, on column slices of wider
    planes."""
    _, (band_r, band_i) = _hband(n, b, dtype, cuda_device, n + 1)
    _, _, vt, taut = bulge_chase_planar_kernel(band_r, band_i, b)
    rng = np.random.default_rng(m)
    wide = torch.tensor(rng.standard_normal((2, n, m + 9)), dtype=dtype, device=cuda_device)
    y = (wide[0, :, 4 : 4 + m], wide[1, :, 4 : 4 + m])
    before = apply_q2_planar_kernel.launches
    got = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
    assert apply_q2_planar_kernel.launches == before + 1
    want = apply_q2_planar(vt, taut, y, n, b, g=g)
    for x, w, y0 in zip(got, want, y):
        assert x.shape == w.shape
        assert _rel(x, w) <= (1e-4 if dtype == torch.float32 else 1e-11)
        assert _rel(w, y0) > 0.1  # the replay moves y
