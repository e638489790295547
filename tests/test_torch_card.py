"""The port's kernels (K1..K10) against their plain PyTorch versions on the
card.

Needs an NVIDIA GPU with nvcc; skips with a reason elsewhere. Imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_card.py --noconftest -m cuda -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)
"""

import functools
import os
import pathlib
import subprocess
import sys
import time

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


def _device_launches(fn, key):
    """The result of ``fn()``, the number of kernels whose name holds
    ``key`` that it launched, from the profiler's device records, and the
    number of calls of ``fn`` made: a profile that caught no record of such
    a kernel (the profiler dropped records now and then on the card, for a
    cause not established) is taken again, a second later, up to four
    calls; the callers check the wrappers' launch counters against the
    calls made. As chip_smoke.py's profiles of one wrapper's call do, each
    profile takes the CPU activity too and starts fn a tenth of a second
    into its session: CUDA-only profiles lost every record in a long
    process on the card, these did not."""
    from torch.profiler import ProfilerActivity, profile

    for calls in range(1, 5):
        if calls > 1:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.1)
            out = fn()
            torch.cuda.synchronize()
        launched = sum(key in e.name() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA)
        if launched:
            return out, launched, calls
    raise ProfilerDropped(f"{calls} profiles caught no device record of {key!r}")


class ProfilerDropped(AssertionError):
    """No profile of a call caught a record of the kernel it counts."""


def _fresh_process_on_drop(test):
    """Run the test; if its profiles caught no record of the kernel it
    counts (ProfilerDropped: in a long process on the card the profiler has
    stopped catching records, while a new process caught them), run the
    same test once more in a new pytest process, as chip_smoke.py runs a
    group again, and pass or fail with it."""
    @functools.wraps(test)
    def run(*args, **kwargs):
        try:
            return test(*args, **kwargs)
        except ProfilerDropped:
            if os.environ.get("CARD_TEST_FRESH_PROCESS"):
                raise
        node = os.environ["PYTEST_CURRENT_TEST"].rsplit(" ", 1)[0]
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", node, "--noconftest", "-m", "cuda", "-q",
             "-p", "no:cacheprovider"],
            cwd=pathlib.Path(__file__).resolve().parent.parent, capture_output=True, text=True,
            env={**os.environ, "CARD_TEST_FRESH_PROCESS": "1"})
        assert proc.returncode == 0, f"{node} in a new process:\n{proc.stdout[-4000:]}"

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 32, 33, 100, 128])
def test_pchol_block_kernel_matches_plain(cuda_device, nb):
    """K1 within 1e-4 relative (Frobenius) of its plain version in all four
    outputs (both planes of L and of its inverse), fail exact, also past a
    bad pivot (rows 7, 31 and 32: inside, at the end of and just past the
    first 32-column block) and a NaN pivot, where L is held on all rows of
    the columns before the pivot and the inverse on the leading block; two
    calls bit-identical."""
    rng = np.random.default_rng(nb)
    t = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    a0 = t @ t.conj().T + nb * np.eye(nb)
    for bad in (None, 7, 31, 32, "nan"):
        a = a0.copy()
        row = nb // 2 if bad == "nan" else bad
        if row is not None and row >= nb:
            continue
        if row is not None:
            a[row, row] = np.nan if bad == "nan" else -1e4
        dr, di = _planes(a, cuda_device)
        before = pchol_block_planar.launches
        got = pchol_block_planar(dr, di)
        want = pchol_block_plain(dr, di)
        assert pchol_block_planar.launches == before + 1
        assert int(got[4]) == int(want[4]) == (0 if row is None else row + 1)
        k = nb if row is None else row
        # L's columns before the pivot are fixed on every row; the inverse's
        # leading block is the inverse of L's
        held = [(x[:, :k], y[:, :k]) for x, y in zip(got[:2], want[:2])]
        held += [(x[:k, :k], y[:k, :k]) for x, y in zip(got[2:4], want[2:4])]
        for g, w in held:
            g, w = g.cpu(), w.cpu()
            # an all-zero plane (the imaginary parts at nb = 1) must match exactly
            assert float(torch.linalg.norm(g - w)) <= 1e-4 * float(torch.linalg.norm(w))
        # bit-identical from call to call, NaN where NaN (past a bad pivot)
        again = pchol_block_planar(dr, di)
        assert all(bool(((x == y) | (x.isnan() & y.isnan())).all()) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [128, 100])
@_fresh_process_on_drop
def test_pchol_block_kernel_batched(cuda_device, nb):
    """K1 on a batch of 64 blocks in one launch (profiler), read through
    the batched Cholesky's panel view (the leading nb rows of (64, 2 nb, nb)
    panels: a batch stride and a row stride of their own). Item 5 has a bad
    pivot at row 37. Each item's outputs are bit-identical to the unbatched
    launch on that item; within 1e-4 relative of the plain version (L on the
    columns before a bad pivot, the inverse on the leading block); fail
    exact."""
    batch = 64
    rng = np.random.default_rng(nb + 1)
    t = rng.standard_normal((batch, nb, nb)) + 1j * rng.standard_normal((batch, nb, nb))
    a = t @ t.conj().transpose(0, 2, 1) + nb * np.eye(nb)
    a[5, 37, 37] = -1e4
    pan = np.concatenate([a, rng.standard_normal((batch, nb, nb))], 1)
    pr, pi = _planes(pan, cuda_device)
    dr, di = pr[:, :nb], pi[:, :nb]
    assert dr.stride() == (2 * nb * nb, nb, 1)
    before = pchol_block_planar.launches
    got, launched, calls = _device_launches(lambda: pchol_block_planar(dr, di), "pchol")
    assert pchol_block_planar.launches == before + calls and launched == 1
    assert got[4].shape == (batch,)
    want = pchol_block_plain(dr, di)
    assert got[4].cpu().tolist() == want[4].cpu().tolist() == [0] * 5 + [38] + [0] * 58
    for k in range(batch):
        one = pchol_block_planar(dr[k], di[k])
        for x, y in zip(got, one):
            assert bool(((x[k] == y) | (x[k].isnan() & y.isnan())).all())
        c = 37 if k == 5 else nb
        held = [(x[k][:, :c], y[k][:, :c]) for x, y in zip(got[:2], want[:2])]
        held += [(x[k][:c, :c], y[k][:c, :c]) for x, y in zip(got[2:4], want[2:4])]
        for g, w in held:
            assert float(torch.linalg.norm(g - w)) <= 1e-4 * float(torch.linalg.norm(w))


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
@pytest.mark.parametrize("mb,view", [(256, False), (256, True), (2048, False), (2048, True)])
@_fresh_process_on_drop
def test_latrd_panel_kernel_launches_once_and_is_bit_reproducible(cuda_device, mb, view):
    """K2 is one kernel launch a panel (profiler), two calls give the same
    bits (its grid-wide sums run in block order), and it stays within rtol
    1e-4 / atol 1e-3 of its plain version; contiguous planes and a bucket
    view whose row stride exceeds mb, at full and cut panel ends."""
    n = mb + 64 if view else mb
    rng = np.random.default_rng(mb + view)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    ar, ai = _planes((t + t.conj().T) / 2, cuda_device)
    ar, ai = ar[:mb, :mb], ai[:mb, :mb]
    latrd_panel_planar(ar, ai, mb)  # builds the kernel
    for pe in (mb, mb - 32):
        before = latrd_panel_planar.launches
        got, launched, calls = _device_launches(lambda: latrd_panel_planar(ar, ai, pe), "latrd_")
        assert launched == 1 and latrd_panel_planar.launches == before + calls
        again = latrd_panel_planar(ar, ai, pe)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
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


def _mv_operands(n, dtype, dev, seed):
    """A symmetric n x n matrix, an antisymmetric one and two vectors."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n))
    up = np.triu(rng.standard_normal((n, n)), 1)
    mats = [torch.tensor(x, dtype=dtype, device=dev) for x in ((t + t.T) / 2, up - up.T)]
    vecs = [torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev) for _ in range(2)]
    return mats, vecs


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["symv", "hemv_planar"])
@pytest.mark.parametrize("c", [256, 511, 1023, 2047, 3071, 4095])
def test_symv_kernels_at_the_solve_extents(cuda_device, kernel, c):
    """K4 and K3 at the real one-stage solve's extents on the lda = 4096
    view of a 4096^2 matrix: within 1e-4 relative of the plain version in
    fp32 (another summation order)."""
    (a, ai), (v, vi) = _mv_operands(4096, torch.float32, cuda_device, c)
    if kernel == "symv":
        got, want = symv(a, v, extent=c), symv_plain(a[:c, :c], v[:c])
        assert got.shape == (c,) and _rel(got, want) <= 1e-4
    else:
        got = hemv_planar(a, ai, v, vi, extent=c)
        want = hemv_planar_plain(a[:c, :c], ai[:c, :c], v[:c], vi[:c])
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            assert g.shape == (c,) and float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(1, torch.float32), (1, torch.float64),
                                     (999, torch.float32), (999, torch.float64)])
def test_symv_kernels_on_unaligned_rows(cuda_device, n, dtype):
    """Contiguous n = 999 (rows not 16-byte aligned: the element copies)
    and n = 1: K4 within 1e-4 (fp32) and 1e-12 (fp64) relative of the plain
    version, K3 (fp32) within 1e-4."""
    (a, ai), (v, vi) = _mv_operands(n, dtype, cuda_device, n)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    assert _rel(symv(a, v), symv_plain(a, v)) <= tol
    if dtype == torch.float32:
        got, want = hemv_planar(a, ai, v, vi), hemv_planar_plain(a, ai, v, vi)
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [("symv", torch.float32), ("symv", torch.float64),
                                          ("hemv_planar", torch.float32)])
@_fresh_process_on_drop
def test_symv_kernels_launch_once_and_repeat_their_bits(cuda_device, kernel, dtype):
    """At most one kernel launch a call at n = 4096: five calls in one
    profile record between one and five launches of the kernel (the
    profiler loses device records now and then on the card, so not all five
    are required; it never invents one), and the wrapper counts five; then
    20 further calls with the first call's bits."""
    (a, ai), (v, vi) = _mv_operands(4096, dtype, cuda_device, 20)
    if kernel == "symv":
        fn, key, counter = (lambda: (symv(a, v),)), "symv_kernel", symv
    else:
        fn, key, counter = (lambda: hemv_planar(a, ai, v, vi)), "hemv_planar_kernel", hemv_planar
    first = fn()  # builds the kernel
    before = counter.launches
    _, launched, profiles = _device_launches(lambda: [fn() for _ in range(5)], key)
    assert 1 <= launched <= 5 and counter.launches == before + 5 * profiles
    for _ in range(20):
        assert all(torch.equal(x, y) for x, y in zip(fn(), first))


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,rb,dtype", [
    (512, 32, 448, torch.float32), (1000, 24, 500, torch.float32),
    (128, 16, 64, torch.float32), (512, 32, 448, torch.float64),
    (4096, 32, 4032, torch.float32), (1100, 16, 1000, torch.float32)])
def test_ql_panel_kernel_matches_plain(cuda_device, m, b, rb, dtype):
    """K5 within 1e-4 relative of its plain version in fp32 (sums in
    another order), 1e-11 in fp64, on a column slice of a wider matrix;
    the trivial-column contract (tau = 0, v = 0, column kept) exactly, in
    one block at m = 128 and with the zero tail across the row slabs of 5
    blocks at m = 1100; the main path's (4096, 32) over 16 blocks; two calls
    bit-identical."""
    rng = np.random.default_rng(m)
    wide = torch.tensor(rng.standard_normal((m, b + 40)), dtype=dtype, device=cuda_device)
    p = wide[:, 11 : 11 + b]
    special = m in (128, 1100)
    if special:
        p[: rb + b - 1, b - 1] = 0.0
    before = ql_panel.launches
    got = ql_panel(p, rb)
    assert ql_panel.launches == before + 1
    want = ql_panel_plain(p, rb)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= tol
    assert all(torch.equal(x, y) for x, y in zip(got, ql_panel(p, rb)))
    if special:
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chase_kernel_with_more_slots_than_sms(cuda_device, dtype):
    """K7 at n = 2400, b = 6: its 134 slots outnumber the H100's 132 SMs,
    so two blocks of the persistent kernel own two slots. The reflectors of
    so narrow a band are ill-conditioned functions of it (a perturbation of
    the band in its last bits moves the plain chase's own by about 1e-6 in
    fp64, whole arrays, and by 1e-2 and more in fp32, already on its first
    sweeps; both measured on the card), so, as chip_smoke.py holds the
    fp64 instance: fp64 d and e whole and the reflectors on the first 64
    sweeps (1e-7); fp32 d and |e| on the first 64 sweeps (1e-3);
    and the whole output through what it must satisfy, the spectrum of
    (d, e) and Q2 T Q2^T = A (Q2 the plain replay of the kernel's
    reflectors), both to 1e-4 relative. Two calls bit-identical."""
    n, b, h = 2400, 6, 64
    a, band = _band(n, b, dtype, cuda_device, 24)
    got = bulge_chase_kernel(band, b)
    want = bulge_chase(band, b)
    act = (want[3] != 0)[..., None]
    if dtype == torch.float64:
        pairs = [(got[0], want[0]), (got[1], want[1]),
                 ((got[2] * act)[: 3 * h], (want[2] * act)[: 3 * h]),
                 (got[3][: 3 * h], want[3][: 3 * h])]
        tol = 1e-7
    else:
        pairs = [(got[0][:h], want[0][:h]), (got[1][:h].abs(), want[1][:h].abs())]
        tol = 1e-3
    for g, w in pairs:
        assert g.shape == w.shape and _rel(g, w) <= tol
    assert all(torch.equal(x, y) for x, y in zip(got, bulge_chase_kernel(band, b)))
    d, e = got[0].double(), got[1].double()
    tri = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    w_a = np.linalg.eigvalsh(a)
    w_t = np.linalg.eigvalsh(tri.cpu().numpy())
    assert np.abs(w_t - w_a).max() <= 1e-4 * np.abs(w_a).max()
    q2 = apply_q2(got[2], got[3], torch.eye(n, dtype=dtype, device=cuda_device), n, b, g=b)
    sim = q2.double() @ tri @ q2.double().T
    assert _rel(sim, torch.tensor(a, device=cuda_device)) <= 1e-4


@pytest.mark.cuda
def test_chase_kernel_launches_once_per_real_two_stage_solve(cuda_device):
    """A real two-stage solve launches K7's persistent kernel once, counted
    by the profiler's device records and by the wrapper."""
    from torch.profiler import ProfilerActivity, profile

    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.utils.testing import random_spd_pair

    a, b = random_spd_pair(512, seed=5)
    cfg = SolverConfig(tridiag_mode="two")
    dsygvdx(a, b, il=1, iu=16, device="cuda", cfg=cfg)  # builds the kernels
    before = bulge_chase_kernel.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = dsygvdx(a, b, il=1, iu=16, device="cuda", cfg=cfg)
        torch.cuda.synchronize()
    assert int(res.info) == 0 and bulge_chase_kernel.launches == before + 1
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("chase_kernel" in x for x in names) == 1


def _random_hbands(batch, n, b, dtype, dev, seed):
    """Both lower band planes (batch, n, 2b) of a batch of random Hermitian
    band matrices of half-width b (real diagonals)."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((2, batch, n, 2 * b))
    planes[0, :, :, : b + 1] = rng.standard_normal((batch, n, b + 1))
    planes[1, :, :, 1 : b + 1] = rng.standard_normal((batch, n, b))
    planes[:, :, np.arange(n)[:, None] + np.arange(2 * b)[None, :] >= n] = 0.0
    t = torch.tensor(planes, dtype=dtype, device=dev)
    return t[0], t[1]


@pytest.mark.cuda
@_fresh_process_on_drop
def test_ql_panel_planar_kernel_batched(cuda_device):
    """K6 on a batch of 5 panels in one launch (profiler; a cluster an
    item), the panels column slices of (5, 1100, 64) planes (a batch stride
    and a row stride of their own), m = 1100, b = 16, rb = 1000: four blocks
    an item, so the slabs cross blocks. Each item's eight outputs are
    bit-identical to the unbatched launch on that item, and within 1e-4
    relative of the plain version."""
    batch, m, b, rb = 5, 1100, 16, 1000
    rng = np.random.default_rng(61)
    wide = torch.tensor(rng.standard_normal((2, batch, m, 64)), dtype=torch.float32,
                        device=cuda_device)
    pr, pi = wide[0, :, :, 7 : 7 + b], wide[1, :, :, 7 : 7 + b]
    assert pr.stride() == (m * 64, 64, 1)
    before = ql_panel_planar.launches
    got, launched, calls = _device_launches(lambda: ql_panel_planar(pr, pi, rb), "ql_panel")
    assert ql_panel_planar.launches == before + calls and launched == 1
    want = ql_panel_planar_plain(pr, pi, rb)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.shape[0] == batch
        assert _rel(x, y) <= 1e-4
    for k in range(batch):
        one = ql_panel_planar(pr[k], pi[k], rb)
        assert all(torch.equal(x[k], y) for x, y in zip(got, one))


@pytest.mark.cuda
@_fresh_process_on_drop
def test_chase_planar_kernel_batched(cuda_device):
    """K8 on a batch of 64 bands at n = 1024, b = 32, fp32 in one launch
    (profiler): 704 (item, slot) pairs, more than the blocks that fit on the
    card at once, so blocks own several pairs. Each item's d, e, reflectors
    and taus are bit-identical to the unbatched launch on that item."""
    from eigensolver_gpu_torch.ops.chase import chase_planar_blocks
    from eigensolver_gpu_torch.ops.sb2st import chase_dims

    batch, n, b = 64, 1024, 32
    band_r, band_i = _random_hbands(batch, n, b, torch.float32, cuda_device, 81)
    pairs = batch * chase_dims(n, b)[0]
    assert pairs == 704 and chase_planar_blocks(b, pairs, torch.float32) < pairs
    before = bulge_chase_planar_kernel.launches
    got, launched, calls = _device_launches(
        lambda: bulge_chase_planar_kernel(band_r, band_i, b), "chase_planar")
    assert bulge_chase_planar_kernel.launches == before + calls and launched == 1
    for k in range(batch):
        one = bulge_chase_planar_kernel(band_r[k], band_i[k], b)
        assert all(x.shape[0] == batch and torch.equal(x[k], y)
                   for x, y in zip(_flat(got), _flat(one)))


@pytest.mark.cuda
@_fresh_process_on_drop
def test_replay_planar_kernel_batched(cuda_device):
    """K10 on a batch of 3 problems in one launch (profiler), n = 300,
    b = 8, g = 24, m = 70, fp32: within 1e-4 relative of the plain version;
    and on the batch's window store, each item's result is bit-identical to
    the launch on that item's windows alone (the zero fill past row n stays
    inside the item)."""
    from eigensolver_gpu_torch.ops.replay import replay_planar_store, window_store_planar

    batch, n, b, g, m = 3, 300, 8, 24, 70
    band_r, band_i = _random_hbands(batch, n, b, torch.float32, cuda_device, 101)
    _, _, vt, taut = bulge_chase_planar_kernel(band_r, band_i, b)
    rng = np.random.default_rng(102)
    y = tuple(torch.tensor(rng.standard_normal((batch, n, m)), dtype=torch.float32,
                           device=cuda_device) for _ in range(2))
    before = apply_q2_planar_kernel.launches
    got, launched, calls = _device_launches(
        lambda: apply_q2_planar_kernel(vt, taut, y, n, b, g=g), "replay_planar")
    assert apply_q2_planar_kernel.launches == before + calls and launched == 1
    want = apply_q2_planar(vt, taut, y, n, b, g=g)
    for x, w, y0 in zip(got, want, y):
        assert x.shape == w.shape == (batch, n, m)
        assert _rel(x, w) <= 1e-4 and _rel(w, y0) > 0.1
    store, table = window_store_planar(vt, taut, n, b, g)
    row0 = torch.tensor(table["row0"], dtype=torch.int32, device=cuda_device)
    l_win = table["geo"]["l_win"]
    got = replay_planar_store(store, row0, y, l_win)
    for k in range(batch):
        one = replay_planar_store(store[:, k], row0, (y[0][k], y[1][k]), l_win)
        assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1])


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 100, 4096])
@_fresh_process_on_drop
def test_replay_kernel_across_widths(cuda_device, m, dtype):
    """K9 at the main path's n = 4096, b = 32 (g = 96 in fp32, the
    pure-fp64 path's g = b in fp64) at m = 1, 100 and 4096 columns: within
    1e-4 (fp32) and 1e-11 (fp64) relative of sb2st.apply_q2, one kernel
    launch a call (profiler), two calls bit-identical."""
    n, b = 4096, 32
    g = 96 if dtype == torch.float32 else b
    _, band = _band(n, b, dtype, cuda_device, 11)
    _, _, vt, taut = bulge_chase_kernel(band, b)
    rng = np.random.default_rng(m)
    y = torch.tensor(rng.standard_normal((n, m)), dtype=dtype, device=cuda_device)
    apply_q2_kernel(vt, taut, y, n, b, g=g)  # builds the kernel
    before = apply_q2_kernel.launches
    got, launched, calls = _device_launches(lambda: apply_q2_kernel(vt, taut, y, n, b, g=g),
                                            "replay_kernel")
    assert launched == 1 and apply_q2_kernel.launches == before + calls
    assert torch.equal(got, apply_q2_kernel(vt, taut, y, n, b, g=g))
    want = apply_q2(vt, taut, y, n, b, g=g)
    assert got.shape == want.shape == (n, m)
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-11)
    assert _rel(want, y) > 0.1


@pytest.mark.cuda
@_fresh_process_on_drop
def test_replay_kernel_launches_once_per_real_two_stage_solve(cuda_device):
    """A real two-stage solve launches K9's kernel once, counted by the
    profiler's device records and by the wrapper."""
    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.utils.testing import random_spd_pair

    a, b = random_spd_pair(512, seed=6)
    cfg = SolverConfig(tridiag_mode="two")
    dsygvdx(a, b, il=1, iu=16, device="cuda", cfg=cfg)  # builds the kernels
    before = apply_q2_kernel.launches
    res, launched, calls = _device_launches(
        lambda: dsygvdx(a, b, il=1, iu=16, device="cuda", cfg=cfg), "replay_kernel")
    assert int(res.info) == 0 and launched == 1
    assert apply_q2_kernel.launches == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,rb,dtype", [
    (512, 32, 448, torch.float32), (1000, 24, 500, torch.float32),
    (128, 16, 64, torch.float32), (512, 32, 448, torch.float64), (200, 64, 100, torch.float64),
    (40, 8, 20, torch.float32), (4096, 32, 4032, torch.float32), (300, 1, 250, torch.float32),
    (1100, 16, 1000, torch.float32), (4096, 64, 3968, torch.float64)])
def test_ql_panel_planar_kernel_matches_plain(cuda_device, m, b, rb, dtype):
    """K6 within 1e-4 relative of its plain version in fp32 (sums in another
    order), 1e-11 in fp64, on column slices of wider planes; a trivial column
    (zero tail, real pivot) and a phase-only column (zero tail, complex
    pivot: tau != 0, the pivot rotated to real) exactly as the contract says,
    at m = 128 in one block and at m = 1100 with both tails across the row
    slabs of 4 blocks; a panel with fewer rows than a slab (m = 40), the
    main path's (4096, 32), b = 1, and fp64 slabs in global memory."""
    rng = np.random.default_rng(m)
    wide_r = torch.tensor(rng.standard_normal((m, b + 40)), dtype=dtype, device=cuda_device)
    wide_i = torch.tensor(rng.standard_normal((m, b + 40)), dtype=dtype, device=cuda_device)
    pr, pi = wide_r[:, 11 : 11 + b], wide_i[:, 11 : 11 + b]
    special = m in (128, 1100)
    if special:
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
    if special:
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
                                       (100, 6, torch.float64), (300, 32, torch.float64),
                                       (2400, 6, torch.float64)])
def test_chase_planar_kernel_matches_plain(cuda_device, n, b, dtype):
    """K8 against its plain version: d, e, tau and the active reflectors
    within 1e-3 relative in fp32 at these sizes (drift along the dependent
    steps), 1e-9 in fp64 (1e-7 at n = 2400, chip_smoke.py's fp64 bound: the
    drift grows with the 7192 steps); the spectrum of (d, |e|) kept; two
    calls bit-identical. At n = 2400, b = 6 the 134 slots outnumber the
    H100's 132 SMs; the kernel runs as many blocks as fit on the card at
    once, up to one a slot."""
    a, (band_r, band_i) = _hband(n, b, dtype, cuda_device, n)
    before = bulge_chase_planar_kernel.launches
    got = bulge_chase_planar_kernel(band_r, band_i, b)
    assert bulge_chase_planar_kernel.launches == before + 1
    want = bulge_chase_planar(band_r, band_i, b)
    act = ((want[3][0] != 0) | (want[3][1] != 0))[..., None]
    tol = 1e-3 if dtype == torch.float32 else 1e-9 if n < 2400 else 1e-7
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,g,m,dtype", [(4096, 32, 96, 1, torch.float32),
                                           (4096, 32, 96, 100, torch.float32),
                                           (4096, 32, 96, 4096, torch.float32),
                                           (1024, 32, 32, 256, torch.float64)])
def test_replay_planar_kernel_across_widths(cuda_device, n, b, g, m, dtype):
    """K10 at the main path's shape (n = 4096, b = 32, g = 96: its first and
    last waves hold a single window) at m = 1, 100 and 4096 columns, and in
    fp64 at the pure-fp64 path's g = b: within 1e-4 (fp32) and 1e-11 (fp64)
    relative of sb2st_planar.apply_q2_planar; one launch a call."""
    from eigensolver_gpu_torch.ops.replay import window_table

    per_wave = np.diff(window_table(n, b, g)["wave_ptr"])
    assert per_wave[0] == per_wave[-1] == 1 and per_wave.max() > 1
    _, (band_r, band_i) = _hband(n, b, dtype, cuda_device, 7)
    _, _, vt, taut = bulge_chase_planar_kernel(band_r, band_i, b)
    rng = np.random.default_rng(m)
    y = tuple(torch.tensor(rng.standard_normal((n, m)), dtype=dtype, device=cuda_device)
              for _ in range(2))
    before = apply_q2_planar_kernel.launches
    got = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
    assert apply_q2_planar_kernel.launches == before + 1
    want = apply_q2_planar(vt, taut, y, n, b, g=g)
    for x, w, y0 in zip(got, want, y):
        assert x.shape == w.shape == (n, m)
        assert _rel(x, w) <= (1e-4 if dtype == torch.float32 else 1e-11)
        assert _rel(w, y0) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,g,m,dtype", [(1024, 32, 96, 300, torch.float32),
                                           (300, 32, 32, 33, torch.float64)])
def test_replay_planar_kernel_is_bit_reproducible(cuda_device, n, b, g, m, dtype):
    """Two K10 calls on the same inputs give the same bits (the sums run in
    a fixed order)."""
    _, (band_r, band_i) = _hband(n, b, dtype, cuda_device, 8)
    _, _, vt, taut = bulge_chase_planar_kernel(band_r, band_i, b)
    rng = np.random.default_rng(n)
    y = tuple(torch.tensor(rng.standard_normal((n, m)), dtype=dtype, device=cuda_device)
              for _ in range(2))
    first = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
    second = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
    assert all(torch.equal(x, z) for x, z in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(64, 64, 64), (257, 129, 65), (512, 4096, 96)])
def test_ozaki_card_digit_gemm_gives_the_cpu_bits(cuda_device, n, k, m):
    """The ozaki products on the card (bf16 digit gemms with an fp32
    result) give the CPU route's bits (fp32 gemms of the digits): both sums
    are exact integers. Also a transposed lhs, a batch and the planar
    form."""
    from eigensolver_gpu_torch.ops import ozaki

    rng = np.random.default_rng(k)
    a = torch.tensor(rng.standard_normal((n, k)) * np.exp2(rng.integers(-30, 30, (n, 1))))
    b = torch.tensor(rng.standard_normal((k, m)))
    dev = lambda x: x.to(cuda_device)
    assert torch.equal(ozaki.ozaki_matmul(dev(a), dev(b)).cpu(), ozaki.ozaki_matmul(a, b))
    dbits = ozaki.digit_bits_for(k)
    ns = ozaki.nslice_for(dbits)
    at = a.mT.contiguous()  # (k, n): its rows are contracted
    got = ozaki.ozaki_matmul_pre(ozaki.ozaki_slice(dev(at), 1, dbits, ns),
                                 ozaki.ozaki_slice(dev(b), 1, dbits, ns), dbits,
                                 transpose_lhs=True)
    want = ozaki.ozaki_matmul_pre(ozaki.ozaki_slice(at, 1, dbits, ns),
                                  ozaki.ozaki_slice(b, 1, dbits, ns), dbits, transpose_lhs=True)
    assert torch.equal(got.cpu(), want)
    batch = torch.stack([b, 2 * b])
    lhs = torch.stack([a, -a])
    assert torch.equal(ozaki.ozaki_matmul(dev(lhs), dev(batch)).cpu(),
                       ozaki.ozaki_matmul(lhs, batch))
    pg = ozaki.ozaki_pmatmul((dev(a), dev(0.5 * a)), (dev(b), dev(-b)))
    pw = ozaki.ozaki_pmatmul((a, 0.5 * a), (b, -b))
    assert torch.equal(pg[0].cpu(), pw[0]) and torch.equal(pg[1].cpu(), pw[1])


@pytest.mark.cuda
def test_trinv_matches_blockinv_on_the_card(cuda_device):
    """planar_solve_mode='trinv' (ptrinv_lower and planar gemms; 8 K1
    launches) against the default 'blockinv' at n = 1024, iu = 128, mp:
    eigenvalues within 1e-12 relative, vectors phase-insensitively within
    1e-8, both with residual at the fp64 contract."""
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar_host
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.utils.testing import compare_vectors, ge_residual, random_hpd_pair

    n, iu = 1024, 128
    a, b = random_hpd_pair(n, seed=3)
    out = {}
    for mode in ("blockinv", "trinv"):
        pchol_block_planar.launches = 0
        res = zhegvdx_planar_host(a, b, il=1, iu=iu, device="cuda", cfg=SolverConfig(
            compute_dtype="float32", planar_solve_mode=mode))
        assert pchol_block_planar.launches == n // 128 and int(res.info) == 0
        w = res.w.cpu().numpy()
        z = res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
        assert ge_residual(a, b, w, z) < 1e-12
        out[mode] = (w, z)
    (w0, z0), (w1, z1) = out["blockinv"], out["trinv"]
    assert np.abs(w1 - w0).max() < 1e-12 * np.abs(w0).max()
    assert compare_vectors(z1, z0) < 1e-8


@pytest.mark.cuda
@_fresh_process_on_drop
def test_ql_panel_kernel_batched(cuda_device):
    """K5 on a batch of 5 panels in one launch (profiler; a cluster an
    item), the panels column slices of (5, 1100, 64) matrices (a batch
    stride and a row stride of their own), m = 1100, b = 16, rb = 1000: five
    blocks an item, so the slabs cross blocks. Each item's four outputs are
    bit-identical to the unbatched launch on that item, and within 1e-4
    relative of the plain version."""
    batch, m, b, rb = 5, 1100, 16, 1000
    rng = np.random.default_rng(51)
    wide = torch.tensor(rng.standard_normal((batch, m, 64)), dtype=torch.float32,
                        device=cuda_device)
    p = wide[:, :, 7 : 7 + b]
    assert p.stride() == (m * 64, 64, 1)
    before = ql_panel.launches
    got, launched, calls = _device_launches(lambda: ql_panel(p, rb), "ql_panel_kernel")
    assert ql_panel.launches == before + calls and launched == 1
    want = ql_panel_plain(p, rb)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.shape[0] == batch
        assert _rel(x, y) <= 1e-4
    for k in range(batch):
        one = ql_panel(p[k], rb)
        assert all(torch.equal(x[k], y) for x, y in zip(got, one))


@pytest.mark.cuda
@_fresh_process_on_drop
def test_chase_kernel_batched(cuda_device):
    """K7 on a batch of 64 bands at n = 1024, b = 32, fp32 in one launch
    (profiler): 704 (item, slot) pairs, more than the blocks that fit on the
    card at once, so blocks own several pairs. Each item's d, e, reflectors
    and taus are bit-identical to the unbatched launch on that item."""
    from eigensolver_gpu_torch.ops.chase import chase_blocks
    from eigensolver_gpu_torch.ops.sb2st import chase_dims

    batch, n, b = 64, 1024, 32
    band = torch.stack([_band(n, b, torch.float32, cuda_device, 70 + k)[1]
                        for k in range(batch)])
    pairs = batch * chase_dims(n, b)[0]
    assert pairs == 704 and chase_blocks(b, pairs, torch.float32) < pairs
    before = bulge_chase_kernel.launches
    got, launched, calls = _device_launches(lambda: bulge_chase_kernel(band, b), "chase_kernel")
    assert bulge_chase_kernel.launches == before + calls and launched == 1
    for k in range(batch):
        one = bulge_chase_kernel(band[k], b)
        assert all(x.shape[0] == batch and torch.equal(x[k], y) for x, y in zip(got, one))


@pytest.mark.cuda
@_fresh_process_on_drop
def test_replay_kernel_batched(cuda_device):
    """K9 on a batch of 3 problems in one launch (profiler), n = 300,
    b = 8, g = 24, m = 70, fp32: within 1e-4 relative of the plain version;
    and on the batch's window store, each item's result is bit-identical to
    the launch on that item's windows alone (the zero fill past row n stays
    inside the item)."""
    from eigensolver_gpu_torch.ops.replay import replay_store, window_store

    batch, n, b, g, m = 3, 300, 8, 24, 70
    band = torch.stack([_band(n, b, torch.float32, cuda_device, 90 + k)[1]
                        for k in range(batch)])
    _, _, vt, taut = bulge_chase_kernel(band, b)
    y = torch.tensor(np.random.default_rng(92).standard_normal((batch, n, m)),
                     dtype=torch.float32, device=cuda_device)
    before = apply_q2_kernel.launches
    got, launched, calls = _device_launches(lambda: apply_q2_kernel(vt, taut, y, n, b, g=g),
                                            "replay_kernel")
    assert apply_q2_kernel.launches == before + calls and launched == 1
    want = apply_q2(vt, taut, y, n, b, g=g)
    assert got.shape == want.shape == (batch, n, m)
    assert _rel(got, want) <= 1e-4 and _rel(want, y) > 0.1
    store, table = window_store(vt, taut, n, b, g)
    row0 = torch.tensor(table["row0"], dtype=torch.int32, device=cuda_device)
    l_win = table["geo"]["l_win"]
    got = replay_store(store, row0, y, l_win)
    for k in range(batch):
        assert torch.equal(got[k], replay_store(store[k], row0, y[k], l_win))


@pytest.mark.cuda
@_fresh_process_on_drop
def test_batched_real_two_stage_solve_launches_each_kernel_once_a_panel(cuda_device):
    """sygvdx_batched with tridiag_mode='two' on 4 x n = 512 real pairs,
    iu = 16, fp64: one batched solve, K5 15 launches (one a panel for the
    batch), K7 1 and K9 1 by the wrappers and the profiler; each item
    within 1e-12 n of its unbatched two-stage solve, info 0, ge_residual at
    the fp64 contract."""
    from eigensolver_gpu_torch import SolverConfig, sygvdx, sygvdx_batched
    from eigensolver_gpu_torch.utils.testing import ge_residual, random_spd_pair

    batch, n, iu = 4, 512, 16
    pairs = [random_spd_pair(n, seed=20 + k) for k in range(batch)]
    a = torch.tensor(np.stack([p[0] for p in pairs]), device=cuda_device)
    b = torch.tensor(np.stack([p[1] for p in pairs]), device=cuda_device)
    cfg = SolverConfig(tridiag_mode="two")
    sygvdx_batched(a, b, il=1, iu=iu, cfg=cfg)  # builds the kernels
    before = (ql_panel.launches, bulge_chase_kernel.launches, apply_q2_kernel.launches)
    res, launched, calls = _device_launches(lambda: sygvdx_batched(a, b, il=1, iu=iu, cfg=cfg),
                                            "chase_kernel")
    assert launched == 1
    assert (ql_panel.launches, bulge_chase_kernel.launches, apply_q2_kernel.launches) == (
        before[0] + 15 * calls, before[1] + calls, before[2] + calls)
    assert res.info.tolist() == [0] * batch
    for k in range(batch):
        one = sygvdx(a[k], b[k], il=1, iu=iu, cfg=cfg)
        assert (res.w[k] - one.w).abs().max() < 1e-12 * n
        w, z = res.w[k].cpu().numpy(), res.z[k].cpu().numpy()
        assert ge_residual(pairs[k][0], pairs[k][1], w, z) < 1e-12


@pytest.mark.cuda
def test_embedded_solve_on_the_card(cuda_device):
    """zhegvdx_via_embedding at n = 256, iu = 32, fp64 against
    scipy.linalg.eigh on the card (eigenvalues within 1e-10 n, ge_residual <
    1e-12), and the batched embedded solve of 2 items with
    two_stage_min_n = 256 (one batched real two-stage solve, K7 once) against
    the unbatched one of each item."""
    import scipy.linalg

    from eigensolver_gpu_torch import SolverConfig
    from eigensolver_gpu_torch.ops.complex_embed import (
        zhegvdx_embedded,
        zhegvdx_embedded_batched,
        zhegvdx_via_embedding,
    )
    from eigensolver_gpu_torch.utils.testing import ge_residual, random_hpd_pair

    n, iu = 256, 32
    a, b = random_hpd_pair(n, seed=11)
    res = zhegvdx_via_embedding(a, b, il=1, iu=iu)
    assert res.zr.device.type == "cuda" and int(res.info) == 0
    w, z = res.w.cpu().numpy(), res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True)[:iu]
    assert np.abs(w - w_ref).max() < 1e-10 * n and ge_residual(a, b, w, z) < 1e-12
    pairs = [random_hpd_pair(128, seed=12 + k) for k in range(2)]
    t = lambda x: torch.tensor(np.stack(x), device=cuda_device)
    args = (t([p[0].real for p in pairs]), t([p[0].imag for p in pairs]),
            t([p[1].real for p in pairs]), t([p[1].imag for p in pairs]))
    cfg = SolverConfig(two_stage_min_n=256)
    before = bulge_chase_kernel.launches
    res = zhegvdx_embedded_batched(*args, il=1, iu=16, cfg=cfg)
    assert bulge_chase_kernel.launches == before + 1 and res.info.tolist() == [0, 0]
    for k in range(2):
        one = zhegvdx_embedded(*(x[k] for x in args), il=1, iu=16, cfg=cfg)
        assert (res.w[k] - one.w).abs().max() < 1e-12 * 128


@pytest.mark.cuda
def test_dryrun_multichip_on_one_card(cuda_device):
    """JAX's five dry-run checks in a world of one NCCL rank on the card."""
    from eigensolver_gpu_torch.parallel.dryrun import dryrun_multichip

    assert dryrun_multichip(1, device_type="cuda") == {
        "tp": 0, "dp": [0], "planar": 0, "planar dp": [0], "tp two-stage": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(use_pallas=True), dict(tridiag_mode="two")])
def test_sharded_solve_of_one_rank_launches_the_path_kernels(cuda_device, kw):
    """sygvdx_sharded on make_mesh(1) (one NCCL rank) at n = 1024, iu = 64,
    mp: with use_pallas the one-stage reduction's A v goes through K4 over
    the rank's diagonal block (one launch a column of the 512-aligned
    buckets of 256 columns: n / 2), two-stage through K5 a panel, K7 and K9 once; the result
    equals the unsharded solve's (eigenvalues 1e-12 relative, vectors 1e-8)
    and its residual is below 1e-13."""
    from eigensolver_gpu_torch import SolverConfig, sygvdx
    from eigensolver_gpu_torch.parallel.dryrun import run_calls, run_world
    from eigensolver_gpu_torch.utils.testing import compare_vectors, random_spd_pair

    n, iu = 1024, 64
    a, b = random_spd_pair(n, seed=3)
    cfg = SolverConfig(compute_dtype="float32", **kw)
    (rec,) = run_world(1, run_calls, ([("sygvdx_sharded", (a, b), dict(il=1, iu=iu, cfg=cfg),
                                         (1, 1))], "cuda"), device_type="cuda")
    assert "error" not in rec, rec.get("error")
    w, z, info = rec["out"]
    ref = sygvdx(torch.tensor(a, device=cuda_device), torch.tensor(b, device=cuda_device),
                 il=1, iu=iu, cfg=cfg)
    assert int(info) == int(ref.info) == 0
    rw = ref.w.cpu().numpy()
    assert np.abs(w - rw).max() <= 1e-12 * np.abs(rw).max()
    assert compare_vectors(z, ref.z.cpu().numpy()) < 1e-8
    r = a @ z - (b @ z) * w[None, :]
    assert np.linalg.norm(r, axis=0).max() / (n * np.abs(a).sum(1).max()) < 1e-13
    if kw.get("use_pallas"):
        assert rec["launches"] == {"symv": n // 2}  # the columns of the 512-aligned buckets
    else:
        assert rec["launches"] == {"ql_panel": n // 32 - 1, "bulge_chase_kernel": 1,
                                   "apply_q2_kernel": 1}
    assert rec["stages"]["stedc"] > 0 and rec["stages"]["back"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pe", [1024, 544])
@_fresh_process_on_drop
def test_latrd_panel_kernel_batched(cuda_device, pe):
    """K2 on 6 x mb = 1024 bucket views of (6, 1088, 1088) planes in one
    launch (profiler and counter): on an H100 four groups of 32 blocks are
    resident at once, so the second round has items for two groups and the
    other two only take part in the barriers. Each item's seven outputs are
    bit-identical to the unbatched launch on it and within rtol 1e-4 / atol
    1e-3 of the batched plain version."""
    batch, n, mb = 6, 1088, 1024
    rng = np.random.default_rng(pe)
    t = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    ar, ai = _planes((t + t.conj().transpose(0, 2, 1)) / 2, cuda_device)
    ar, ai = ar[:, :mb, :mb], ai[:, :mb, :mb]
    latrd_panel_planar(ar, ai, pe)  # builds the kernel
    before = latrd_panel_planar.launches
    got, launched, calls = _device_launches(lambda: latrd_panel_planar(ar, ai, pe), "latrd_")
    assert launched == 1 and latrd_panel_planar.launches == before + calls
    for k in range(batch):
        one = latrd_panel_planar(ar[k], ai[k], pe)
        assert all(torch.equal(x[k], y) for x, y in zip(got, one))
    want = latrd_panel_plain(ar, ai, pe)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == batch
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [("symv", torch.float32), ("symv", torch.float64),
                                          ("hemv_planar", torch.float32)])
@pytest.mark.parametrize("extent", [None, 999])
@_fresh_process_on_drop
def test_symv_kernels_batched(cuda_device, kernel, dtype, extent):
    """K4 and K3 on 5 x n = 1024 views of (5, 1040, 1040) matrices (a batch
    and a row stride of their own), full and at extent 999: one launch
    (profiler and counter), every item bit-identical to the unbatched
    launch on it, within 1e-4 relative (fp32) and 1e-12 (fp64) of the
    batched plain version."""
    batch, n = 5, 1024
    rng = np.random.default_rng(n + (extent or 0))
    t = rng.standard_normal((batch, n + 16, n + 16))
    up = np.triu(rng.standard_normal((batch, n + 16, n + 16)), 1)
    a, ai = (torch.tensor(x, dtype=dtype, device=cuda_device)[:, :n, :n]
             for x in ((t + t.transpose(0, 2, 1)) / 2, up - up.transpose(0, 2, 1)))
    v, vi = (torch.tensor(rng.standard_normal((batch, n)), dtype=dtype, device=cuda_device)
             for _ in range(2))
    c = n if extent is None else extent
    if kernel == "symv":
        fn, key, counter = (lambda: (symv(a, v, extent=extent),)), "symv_kernel", symv
        one = lambda k: (symv(a[k], v[k], extent=extent),)
        want = (symv_plain(a[:, :c, :c], v[:, :c]),)
    else:
        fn, key, counter = ((lambda: hemv_planar(a, ai, v, vi, extent=extent)),
                            "hemv_planar_kernel", hemv_planar)
        one = lambda k: hemv_planar(a[k], ai[k], v[k], vi[k], extent=extent)
        want = hemv_planar_plain(a[:, :c, :c], ai[:, :c, :c], v[:, :c], vi[:, :c])
    fn()  # builds the kernel
    before = counter.launches
    got, launched, calls = _device_launches(fn, key)
    assert launched == 1 and counter.launches == before + calls
    for k in range(batch):
        assert all(torch.equal(x[k], y) for x, y in zip(got, one(k)))
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == (batch, c) and float((g - w).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_planar_batched_use_pallas_launches_k2_once_a_panel(cuda_device):
    """zhegvdx_planar_batched(use_pallas=True) on 4 x random_hpd_pair(1024),
    iu = 64, mp: one batched solve with 16 K2 launches (the 1024, 768, 512
    and 256 buckets at bucket 128, four panels each, one launch a panel for
    the batch) and 8 K1 launches; info 0 and each item within 1e-12 relative
    (eigenvalues) and 1e-8 (vectors, compare_vectors) of its unbatched
    use_pallas=True solve."""
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar, zhegvdx_planar_batched
    from eigensolver_gpu_torch.utils.testing import compare_vectors, random_hpd_pair

    batch, n, iu = 4, 1024, 64
    pairs = [random_hpd_pair(n, seed=40 + k) for k in range(batch)]
    args = [torch.tensor(np.stack([f(p[j]) for p in pairs]), device=cuda_device)
            for j in (0, 1) for f in (np.real, np.imag)]  # ar, ai, br, bi
    cfg = SolverConfig(compute_dtype="float32", use_pallas=True)
    before = (latrd_panel_planar.launches, pchol_block_planar.launches)
    res = zhegvdx_planar_batched(*args, il=1, iu=iu, cfg=cfg)
    assert (latrd_panel_planar.launches - before[0], pchol_block_planar.launches - before[1]) == (
        16, 8)
    assert res.info.tolist() == [0] * batch
    for k in range(batch):
        one = zhegvdx_planar(*(x[k] for x in args), il=1, iu=iu, cfg=cfg)
        assert float((res.w[k] - one.w).abs().max()) <= 1e-12 * float(one.w.abs().max())
        z = (res.zr[k] + 1j * res.zi[k]).cpu().numpy()
        assert compare_vectors(z, (one.zr + 1j * one.zi).cpu().numpy()) < 1e-8
