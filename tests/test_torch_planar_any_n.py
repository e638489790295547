"""The planar drivers at any n, held to the benchmark's plain reference.

``zhegvdx_planar`` and ``zhegvdx_planar_batched`` pad an n past 128 that is
not a multiple of 128 to the next multiple, and an n below it to the next
multiple of ``nb_tridiag`` (``models/zhegvdx_planar._pad_pencil``), and
raise the padded block of the tridiagonal matrix above the spectrum
(``_lift_pad``). JAX raises past 128, so these cases
are held to ``port_bench/reference.py`` (plain ``torch.linalg`` in fp64, no
JAX) by the numbers of ``port_bench/check.py``: ``eig_err``, ``residual``
and ``b_orth``, with ``info`` 0. An aligned n takes the code it took before
the padding existed: no ``pad_pencil`` range, no ``pad.rows`` count, no
padded copy.
"""

import importlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar, zhegvdx_planar_batched  # noqa: E402
from eigensolver_gpu_torch.utils import tracing  # noqa: E402
from port_bench import reference  # noqa: E402

t_planar = importlib.import_module("eigensolver_gpu_torch.models.zhegvdx_planar")

torch.set_num_threads(2)

# The benchmark cells' limits (port_bench/workloads/*.json). Every fp64 and
# mixed solve below reads at most 3e-14 (eig_err), 3e-14 (residual) and
# 1e-13 (b_orth): fp64 rounding at these n. The fp32 reference (no
# refinement) reads about 1e-7, 1e-8 and 1e-6, eps32 times a small
# factor: it fails all three (``test_an_fp32_solve_fails_the_limits``).
EIG_ERR = 1e-9  # max |w - w_ref| / max |lambda|
RESIDUAL = 1e-10  # max ||A z - w B z|| / ((||A||_1 + |w| ||B||_1) ||z||)
B_ORTH = 1e-8  # max |Z^H B Z - I|
# An ill-conditioned B (kappa 1e8): a solve through the Cholesky of B is
# accurate to eps64 * kappa = 2e-8 (LAPACK zhegv's error bound), in the
# reference as in the program. Eigenvalues and B-norms agree to 5e-10 and
# 1e-9 at n = 200 and at the aligned n = 256 alike. The residual of the
# small eigenvalues' pairs reads up to 2.6e-10 in fp64 two-stage at
# n = 200 (2.5e-13 at n = 256; the real driver, whose pad values come from
# C's max row sum, reads 1e-9 to 3e-9 at that n): the pad values set
# stedc's scale. 1e-8, about eps64 * kappa, for all three.
ILL_EIG_ERR = 1e-8
ILL_RESIDUAL = 1e-8
ILL_B_ORTH = 1e-8

MODES = {
    "fp64": {},
    "fp64_two": {"tridiag_mode": "two"},
    "mp": {"compute_dtype": "float32"},
    "mp_two": {"compute_dtype": "float32", "tridiag_mode": "two"},
}


def _ranges(n):
    return {"half": (1, n // 2), "all": (1, n), "middle": (n // 3, 2 * n // 3)}


def _herm(n, g, batch):
    t = torch.randn(batch + (n, n), dtype=torch.complex128, generator=g)
    return (t + t.mH) / 2


def pencil(n, seed, batch=(), kind="random"):
    """Planar fp64 (A_re, A_im, B_re, B_im): A Hermitian, B = T T^H / n + I
    (test_zhegvdx.F90's pairs), or one of the hard pencils:
    ``illcond`` B = Q diag(logspace(0, -8)) Q^H (kappa 1e8, so the pencil's
    eigenvalues lie up to 1e8 ||A|| high), ``small`` ||A|| ~ 1e-6 (the C1 case:
    a pad bound of 1 would swallow the spectrum), ``negative`` A shifted so
    every eigenvalue is below -1 (pad values near 0 would sort first)."""
    g = torch.Generator().manual_seed(seed)
    eye = torch.eye(n, dtype=torch.complex128)
    a = _herm(n, g, batch)
    t = torch.randn(batch + (n, n), dtype=torch.complex128, generator=g)
    b = t @ t.mH / n + eye
    if kind == "illcond":
        q, _ = torch.linalg.qr(torch.randn(batch + (n, n), dtype=torch.complex128, generator=g))
        b = (q * torch.logspace(0, -8, n, dtype=torch.float64)) @ q.mH
        b = (b + b.mH) / 2
    elif kind == "small":
        a = a * 1e-6
    elif kind == "negative":
        a = a - (torch.linalg.matrix_norm(a, 2)[..., None, None] + 1) * eye
    elif kind != "random":
        raise ValueError(kind)
    return a.real.contiguous(), a.imag.contiguous(), b.real.contiguous(), b.imag.contiguous()


def numbers(problem, out, il, iu):
    """eig_err, residual and b_orth of one result (check.py's definitions)."""
    a, b = reference.matrices("planar", problem)
    w, zr, zi, info = out
    z = torch.complex(zr, zi)
    w_all = reference.eigvals(a, b)
    scale = w_all.abs().amax(-1, keepdim=True)
    eig_err = float(((w - w_all[..., il - 1 : iu]).abs() / scale).amax())
    residual = float(reference.residuals(a, b, w, z).amax())
    return eig_err, residual, float(reference.b_orthonormality(b, z)), info


def solve(problem, il, iu, cfg):
    entry = zhegvdx_planar if problem[0].dim() == 2 else zhegvdx_planar_batched
    return entry(*problem, il=il, iu=iu, cfg=cfg)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch2"])
@pytest.mark.parametrize("rng", ["half", "all", "middle"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [136, 200, 300])
def test_any_n_matches_the_reference(n, mode, rng, batched):
    il, iu = _ranges(n)[rng]
    problem = pencil(n, 1000 + n, (2,) if batched else ())
    out = solve(problem, il, iu, SolverConfig(**MODES[mode]))
    m = iu - il + 1
    lead = (2,) if batched else ()
    assert out.w.shape == lead + (m,) and out.zr.shape == lead + (n, m)
    eig_err, residual, b_orth, info = numbers(problem, out, il, iu)
    assert torch.all(info == 0)
    assert eig_err <= EIG_ERR and residual <= RESIDUAL and b_orth <= B_ORTH, (
        eig_err, residual, b_orth)


def test_fp32_solve_at_the_cell_size_keeps_fp32_accuracy():
    """The fp32 solve inside the mixed driver at the AUSURF112 cell's n =
    1478, padded to 1536: eig_err 2.3e-6, fp32 rounding. Pad values set
    from C before the reduction (2x its max row sum, about 30x its norm
    here) inflated stedc's fp32 deflation thresholds: 4.3e-4 on an H100,
    beyond the fp64 refinement's reach. 2e-5 lies about a decade from
    each."""
    n = 1478
    problem = pencil(n, 5)
    out = zhegvdx_planar(*[x.float() for x in problem], il=1, iu=n, cfg=SolverConfig())
    eig_err, _, _, info = numbers(
        problem, (out.w.double(), out.zr.double(), out.zi.double(), out.info), 1, n)
    assert int(info) == 0 and eig_err <= 2e-5, eig_err


@pytest.mark.parametrize("n", [136, 300])
def test_an_fp32_solve_fails_the_limits(n):
    """The limits above are tight: the reference in fp32 (complex64, no
    refinement) fails each of them."""
    problem = pencil(n, 1000 + n)
    a, b = reference.matrices("planar", problem)
    w, z = reference.eigh_range(a.to(torch.complex64), b.to(torch.complex64), 1, n)
    out = (w.double(), z.real.double(), z.imag.double(), torch.zeros((), dtype=torch.int32))
    eig_err, residual, b_orth, _ = numbers(problem, out, 1, n)
    assert eig_err > EIG_ERR and residual > RESIDUAL and b_orth > B_ORTH


# fp32 cannot factor a B of kappa 1e8 (info > 0 at every n, aligned too):
# the mixed modes take the small-norm and negative pencils
HARD = [("illcond", "fp64"), ("illcond", "fp64_two"), ("small", "fp64"), ("small", "mp"),
        ("small", "mp_two"), ("negative", "fp64_two"), ("negative", "mp"), ("negative", "mp_two")]


@pytest.mark.parametrize("top", [False, True], ids=["all", "top10"])
@pytest.mark.parametrize("kind,mode", HARD)
@pytest.mark.parametrize("n", [200, 100])
def test_hard_pencils_keep_the_pad_out_of_the_range(n, kind, mode, top):
    """iu = n: the highest eigenpairs are the pencil's own, not pad values
    (which lie above C's spectrum whatever B's conditioning, A's norm or
    sign). n = 200 pads to 256 for the Cholesky, n = 100 to 128 for the
    reduction's block (nb_tridiag 32)."""
    il, iu = (n - 9, n) if top else (1, n)
    problem = pencil(n, 77, kind=kind)
    eig_err, residual, b_orth, info = numbers(
        problem, solve(problem, il, iu, SolverConfig(**MODES[mode])), il, iu)
    limits = ((ILL_EIG_ERR, ILL_RESIDUAL, ILL_B_ORTH) if kind == "illcond"
              else (EIG_ERR, RESIDUAL, B_ORTH))
    assert int(info) == 0
    assert all(v <= lim for v, lim in zip((eig_err, residual, b_orth), limits)), (
        eig_err, residual, b_orth)


@pytest.fixture
def traced():
    tracing.clear()
    tracing.enable(sync=True)
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.clear()


def _pad_spans(spans):
    return ([s for s in spans if s["name"] == "pad_pencil"],
            [s["counts"]["pad.rows"] for s in spans if "pad.rows" in s["counts"]])


@pytest.mark.parametrize("mode", ["fp64", "mp_two"])
def test_aligned_n_takes_no_pad(traced, monkeypatch, mode):
    """n = 256: no pad_pencil range, no pad.rows count, no padded copy."""

    def refuse(*args):
        raise AssertionError("padded an aligned n")

    monkeypatch.setattr(t_planar, "_pad_pencil", refuse)
    problem = pencil(256, 5)
    out = solve(problem, 1, 64, SolverConfig(**MODES[mode]))
    assert int(out.info) == 0
    spans, counts = _pad_spans(tracing.export())
    assert spans == [] and counts == []
    assert any(s["name"] == "potrf" for s in tracing.export())


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch2"])
@pytest.mark.parametrize("mode", ["fp64", "mp_two"])
@pytest.mark.parametrize("n,rows", [(200, 56), (100, 28)], ids=["n200", "n100"])
def test_pad_rows_counted_once_a_call(traced, n, rows, mode, batched):
    """n = 200 pads to 256 and n = 100 to 128 (nb_tridiag 32): pad.rows =
    npad - n once a call (a batch shares it), under a pad_pencil span inside
    the solve's range."""
    problem = pencil(n, 9, (2,) if batched else ())
    for call in range(2):
        tracing.clear()
        solve(problem, 1, 20, SolverConfig(**MODES[mode]))
    spans = tracing.export()
    for call in (1, 2):
        mine = [s for s in spans if s["call"] == call]
        pads, counts = _pad_spans(mine)
        assert counts == [rows]
        assert len(pads) == 2  # the pencil padded, the tridiagonal's pad raised
        by_id = {s["id"]: s for s in mine}
        assert all(by_id[s["parent"]]["name"] == "zhegvdx_planar" for s in pads)


@pytest.mark.parametrize("case", ["random", "zero", "negative", "diagonal"])
def test_lift_pad_sets_the_pad_just_above_the_spectrum(case):
    """The raised pad lies above every eigenvalue of the first n rows, and
    within 1/16 + k/1024 of their Gershgorin bound: a pad far above the
    spectrum sets stedc's scale and widens its pole separation against it."""
    g = torch.Generator().manual_seed(3)
    n, k = 50, 14
    d = torch.randn(2, n + k, generator=g, dtype=torch.float64)
    e = torch.randn(2, n + k - 1, generator=g, dtype=torch.float64)
    if case == "zero":
        d, e = torch.zeros_like(d), torch.zeros_like(e)
    elif case == "negative":
        d = -d.abs() - 10.0
    elif case == "diagonal":
        e = torch.zeros_like(e)
    d2, e2 = t_planar._lift_pad(d.clone(), e.clone(), n)
    assert torch.equal(d2[:, :n], d[:, :n]) and torch.equal(e2[:, : n - 1], e[:, : n - 1])
    assert torch.all(e2[:, n - 1 :] == 0)
    t = torch.diag_embed(d[:, :n]) + torch.diag_embed(e[:, : n - 1], 1) \
        + torch.diag_embed(e[:, : n - 1], -1)
    top = torch.linalg.eigvalsh(t)[:, -1]
    rows = d[:, :n].abs()
    rows[:, 1:] += e[:, : n - 1].abs()
    rows[:, :-1] += e[:, : n - 1].abs()
    bound = torch.where(rows.amax(-1) == 0, 1.0, rows.amax(-1))
    pad = d2[:, n:]
    assert torch.all(pad > top[:, None]) and torch.all(pad > bound[:, None])
    assert torch.all(pad <= bound[:, None] * (1 + 1 / 16 + k / 1024))
    assert torch.all(pad[:, 1:] > pad[:, :-1])
