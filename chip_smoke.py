#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (eigensolver_gpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each reported on its own lines; any mismatch or exception exits
non-zero without printing a result:

  1. device  -- card name and power limit (nvidia-smi), torch and CUDA
                versions; requires compute capability 9.0;
  2. build   -- nvcc builds every csrc/*.cu (one process per source, all
                at once); prints the seconds;
  3. kernels -- each hand-written kernel (K1 Cholesky block, K2 latrd
                panel, K3 planar hemv, K4 symv, K5 and K6 QL panel real
                and planar, K7 and K8 bulge chase, K9 and K10 chase
                replay) against its plain PyTorch version on the same
                inputs on the card, with times of kernel, plain version
                and a library yardstick; K3 also through the planar column
                loop that launches it;
  4. main    -- zhegvdx n=4096, il=1..iu=1024, fp32 pipeline + fp64
                refinement, with use_pallas False (kernel K1) and True
                (K1 and K2): launch counts from one solve, then a timed
                solve, residual computed on the device;
  5. reference -- n=1024 eigenvalues against scipy.linalg.eigh, mixed
                one-stage, then pure fp64 with tridiag_mode='two' (the
                fp64 instances of K6, K8, K10);
  6. main (real) -- dsygvdx n=4096, il=1..iu=512, fp32 pipeline + fp64
                refinement, with use_pallas False and True (kernel K4 on
                every panel column of the 512-aligned buckets);
  7. reference (real) -- dsygvdx n=1024, iu=64 in pure fp64 (Jacobi
                leaves, exact substitution) against scipy.linalg.eigh,
                one-stage and two-stage (fp64 instances of K5, K7, K9);
  8. main (real, two-stage) -- the same dsygvdx n=4096 solve with
                tridiag_mode='two': sbrd (K5 per panel), bulge chase
                (K7), replay (K9) and apply_q1, then one solve with
                mosaic_kernels=False (the plain torch route);
  9. main (planar, two-stage) -- the zhegvdx n=4096 iu=1024 solve of
                phase 4 with tridiag_mode='two': psbrd (K6 per panel),
                planar bulge chase (K8), phase normalisation, replay (K10)
                and apply_q1_planar, then one n=1024 solve with
                mosaic_kernels=False (no launch of K1, K6, K8, K10).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores

N_MAIN, IU_MAIN = 4096, 1024
N_REF, IU_REF = 1024, 256
N_REAL, IU_REAL = 4096, 512  # BASELINE config 2
N_REF_REAL, IU_REF_REAL = 1024, 64  # BASELINE config 1
K1_TOL = 1e-4  # relative max error, fp32, different summation order
K2_TOL = 1e-3  # relative max error, fp32 sums of length <= 4096 in another order
MV_TOL = 1e-4  # K3, K4 in fp32: sums of length <= 4096 in another order
MV_TOL64 = 1e-12  # K4 in fp64
MV_TILE = 64  # tile edge of csrc/symv.cu
BAND, REPLAY_G = 32, 96  # SolverConfig defaults of the fp32 two-stage path
K5_TOL = 1e-4  # relative max error, fp32: sums of length <= 4096 in another order
K5_TOL64 = 1e-11
# K7: relative max error of d, e, tau and the active reflectors against the
# plain version. The entries drift apart along the 12 280 dependent steps
# (on the card: 1.6e-9 in fp64 at n = 4096, order one in fp32), so fp64 is
# held everywhere and fp32 on its first K7_HEAD sweeps (2.7e-4 on the card);
# the whole fp32 output is held through its spectrum and Q2 T Q2^T
K7_TOL, K7_TOL64 = 1e-3, 1e-7
K7_HEAD = 64  # sweeps held elementwise in fp32
K7_SPEC_TOL, K7_SPEC_TOL64 = 1e-4, 1e-12  # spectrum and similarity, relative
K9_TOL = 1e-4  # relative max error, fp32: 127-term sums in another order
K9_TOL64 = 1e-11
# K6: as K5, both planes (complex sums of length <= 4096 in another order)
K6_TOL, K6_TOL64 = 1e-4, 1e-11
# K8: as K7. The subdiagonal is complex and its phase is a worse-conditioned
# function of the band than K7's signs, so fp64 is held everywhere (d, both
# planes of e, tau and the active reflectors) and fp32 on its first K7_HEAD
# sweeps through d, |e|, |tau| and the moduli of the reflector entries; the
# whole fp32 output is held through the spectrum of (d, |e|) and
# Q2 (D T D^H) Q2^H = A_band with D from phase_normalize
K8_TOL, K8_TOL64 = 1e-3, 1e-7
K8_SPEC_TOL, K8_SPEC_TOL64 = 1e-4, 1e-12
N_K8_HELD = 1024  # the fp64 instance and the plain route are held at this n
K10_TOL = 1e-4  # relative max error, fp32: 127-term complex sums in another order
K10_TOL64 = 1e-11
N_PLAIN_ROUTE = 1024  # planar mosaic_kernels=False solve (the eager chase is slow)


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want):
    """(max abs error / max |want|, max abs error)."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    return err / scale, err


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"capability={cap[0]}.{cap[1]} torch={torch.__version__} cuda={torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0 (sm_90a), got {cap}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from eigensolver_gpu_torch.utils import kernel_guard

    names = sorted(p.stem for p in kernel_guard.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    # one nvcc per source, all at once (the loader locks per source)
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(kernel_guard.load, names))
    log(f"build: {names} in {time.perf_counter() - t0:.1f} s")


def _hpd_block(torch, nb, seed, dev):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    a = t @ t.conj().T + nb * np.eye(nb)
    f = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
    return f(a.real), f(a.imag)


def check_k1(torch):
    from eigensolver_gpu_torch.ops.pchol import pchol_block_plain, pchol_block_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev = "cuda"
    nb = 128
    dr, di = _hpd_block(torch, nb, 0, dev)
    got = pchol_block_planar(dr, di)
    want = pchol_block_plain(dr, di)
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got[:4], want[:4])]
    worst = max(e[0] for e in errs)
    log(f"K1 hpd nb={nb}: fail={int(got[4])}/{int(want[4])} rel_err="
        f"{[f'{e[0]:.2e}' for e in errs]}")
    if int(got[4]) != 0 or int(want[4]) != 0 or not worst <= K1_TOL:
        raise RuntimeError("K1 disagrees with its plain version on an HPD block")

    # a block with a bad pivot: fail must match exactly, and the columns
    # before it must agree
    br, bi = _hpd_block(torch, nb, 1, dev)
    br[37, 37] = -1e4
    got_b = pchol_block_planar(br, bi)
    want_b = pchol_block_plain(br, bi)
    torch.cuda.synchronize()
    fk, fp = int(got_b[4]), int(want_b[4])
    cols = max(fk - 1, 1)
    err_b = rel_err(got_b[0][:, :cols], want_b[0][:, :cols])[0]
    log(f"K1 bad pivot: fail kernel={fk} plain={fp} rel_err(cols<{cols})={err_b:.2e}")
    if fk != fp or fk == 0 or not err_b <= K1_TOL:
        raise RuntimeError("K1 fail contract differs from its plain version")

    ms = device_ms(lambda: pchol_block_planar(dr, di), iters=50)
    plain_ms = device_ms(lambda: pchol_block_plain(dr, di), iters=3)
    zc = torch.complex(dr, di)

    def library():
        l, _ = torch.linalg.cholesky_ex(zc)
        eye = torch.eye(nb, dtype=zc.dtype, device=dev)
        return torch.linalg.solve_triangular(l, eye, upper=False)

    library_ms = device_ms(library, iters=50)
    # work the kernel must do for this block: factor + inverse, complex
    flops = 0
    for j in range(nb):
        m = nb - 1 - j
        flops += 2 * m + 8 * m * (m + 1) // 2  # scale column, lower downdate
        flops += 2 * (j + 1) + 8 * m * (j + 1)  # inverse row, downdate
    nbytes = 4 * (2 + 4) * nb * nb + 4
    bound_ms, bound_by = bound(nbytes, flops)
    max_abs = max(e[1] for e in errs)
    log(f"K1 times: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"library (cholesky_ex + solve_triangular, complex64) {library_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    return {
        "name": "pchol_block_planar", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/pchol_block.cu",
        "replaces": "eigensolver_gpu_tpu/ops/pchol_pallas.py:118",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def _k2_work(mb, pe, nb):
    """Bytes and flops one panel needs (leading block reads, column reads,
    output writes; matvecs and compact-WY corrections)."""
    nbytes = 8 * (pe - 1) ** 2 + 8 * mb * nb + 4 * (6 * mb * nb + 4 * nb)
    flops = 0
    for s in range(nb):
        cj = pe - 1 - s
        flops += 8 * cj * cj  # y = A v on the leading cj x cj block
        flops += 16 * s * cj * 2  # W^H v, V^H v and their application
        flops += 16 * s * mb  # a_col corrections
        flops += 20 * mb  # zlarfg, v, packed column, w finish
    return nbytes, flops


def check_k2(torch):
    import numpy as np

    from eigensolver_gpu_torch.ops.latrd import latrd_panel_plain, latrd_panel_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev = "cuda"
    nb = 32
    names = ["vr", "vi", "wr", "wi", "colr", "coli", "scal"]
    max_abs = 0.0
    planes = {}
    for mb in (256, 4096):
        rng = np.random.default_rng(mb)
        t = rng.standard_normal((mb, mb)) + 1j * rng.standard_normal((mb, mb))
        a = (t + t.conj().T) / 2
        ar = torch.tensor(a.real, dtype=torch.float32, device=dev)
        ai = torch.tensor(a.imag, dtype=torch.float32, device=dev)
        planes[mb] = (ar, ai)
    # contiguous planes, then the main path's layout: every bucket below
    # 4096 is an [:mb, :mb] view of the padded 4096^2 planes (row stride 4096)
    cases = [(mb, planes[mb], "") for mb in (256, 4096)]
    cases += [(mb, tuple(p[:mb, :mb] for p in planes[4096]), " view")
              for mb in (256, 3840)]
    for mb, (ar, ai), layout in cases:
        for pe in (mb, mb - 32, 32):
            got = latrd_panel_planar(ar, ai, pe, nb=nb)
            want = latrd_panel_plain(ar, ai, pe, nb=nb)
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            worst = max(e[0] for e in errs)
            max_abs = max(max_abs, max(e[1] for e in errs))
            log(f"K2 mb={mb}{layout} pe={pe}: rel_err " + " ".join(
                f"{n}={e[0]:.1e}" for n, e in zip(names, errs)))
            if not worst <= K2_TOL:
                raise RuntimeError(
                    f"K2 disagrees with its plain version at mb={mb}{layout} pe={pe}")
    mb = 4096
    ar, ai = planes[mb]
    ms = device_ms(lambda: latrd_panel_planar(ar, ai, mb, nb=nb), iters=5)
    plain_ms = device_ms(lambda: latrd_panel_plain(ar, ai, mb, nb=nb), iters=2)
    bound_ms, bound_by = bound(*_k2_work(mb, mb, nb))
    log(f"K2 times at mb={mb} pe={mb}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); no single library call computes a "
        f"zlatrd panel (library_ms null)")
    return {
        "name": "latrd_panel_planar", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/latrd_panel.cu",
        "replaces": "eigensolver_gpu_tpu/ops/latrd_pallas.py:300",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _mv_bound(n, planes):
    """Upper tiles read once per plane, vectors read and written once."""
    nbytes = 4 * planes * (n * n // 2 + n * MV_TILE // 2 + 2 * n)
    flops = 2 * n * n * (1 if planes == 1 else 4)
    return bound(nbytes, flops)


def check_k4(torch):
    import numpy as np

    from eigensolver_gpu_torch.ops.symv import symv, symv_plain
    from eigensolver_gpu_torch.utils.precision import true_fp32
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev = "cuda"
    rng = np.random.default_rng(4)
    t = rng.standard_normal((4096, 4096))
    a64 = torch.tensor((t + t.T) / 2, device=dev)
    v64 = torch.tensor(rng.standard_normal(4096), device=dev)
    a32, v32 = a64.float(), v64.float()
    cases = [  # (label, matrix, vector, extent, tolerance)
        ("n=512 fp32", a32[:512, :512].contiguous(), v32[:512], None, MV_TOL),
        ("n=4096 fp32", a32, v32, None, MV_TOL),
        ("n=3584 view of 4096", a32[:3584, :3584], v32[:3584], None, MV_TOL),
        ("n=1000 odd", a32[:1000, :1000].contiguous(), v32[:1000], None, MV_TOL),
        ("n=4096 extent=2999", a32, v32, 2999, MV_TOL),
        ("n=512 fp64", a64[:512, :512].contiguous(), v64[:512], None, MV_TOL64),
    ]
    max_abs = 0.0
    for label, a, v, extent, tol in cases:
        got = symv(a, v, extent=extent)
        c = a.shape[0] if extent is None else extent
        want = symv_plain(a[:c, :c], v[:c])
        dense = a[:c, :c] @ v[:c]
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        rel_dense, _ = rel_err(got, dense)
        if tol == MV_TOL:
            max_abs = max(max_abs, err)
        log(f"K4 {label}: rel_err vs plain {rel:.2e}, vs dense a @ v {rel_dense:.2e}")
        if got.shape != want.shape or not rel <= tol or not rel_dense <= tol:
            raise RuntimeError(f"K4 disagrees with its plain version at {label}")
    again = symv(a32, v32)
    if not torch.equal(again, symv(a32, v32)):
        raise RuntimeError("K4 is not reproducible from run to run")
    ms = device_ms(lambda: symv(a32, v32), iters=100)
    plain_ms = device_ms(lambda: symv_plain(a32, v32), iters=2)
    with true_fp32():
        library_ms = device_ms(lambda: torch.mv(a32, v32), iters=100)
    bound_ms, bound_by = _mv_bound(4096, 1)
    log(f"K4 times at n=4096 fp32: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"library (torch.mv, full matrix) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "symv", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/symv.cu",
        "replaces": "eigensolver_gpu_tpu/ops/symv_pallas.py:90",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_k3(torch):
    """K3 against its plain version, then through the planar column loop
    that launches it: one mb=4096 panel with use_pallas True against
    False. Returns the kernel's record with the panel's launch count."""
    import numpy as np

    from eigensolver_gpu_torch.ops.symv import hemv_planar, hemv_planar_plain
    from eigensolver_gpu_torch.ops.sytrd_planar import _panel_columns_planar
    from eigensolver_gpu_torch.utils.precision import true_fp32
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev = "cuda"
    rng = np.random.default_rng(3)
    t = rng.standard_normal((4096, 4096)) + 1j * rng.standard_normal((4096, 4096))
    a = (t + t.conj().T) / 2
    f32 = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
    ar, ai = f32(a.real), f32(a.imag)
    v = rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
    vr, vi = f32(v.real), f32(v.imag)
    cases = [
        ("n=512", ar[:512, :512].contiguous(), ai[:512, :512].contiguous(), 512, None),
        ("n=4096", ar, ai, 4096, None),
        ("n=3584 view of 4096", ar[:3584, :3584], ai[:3584, :3584], 3584, None),
        ("n=1000 odd", ar[:1000, :1000].contiguous(), ai[:1000, :1000].contiguous(),
         1000, None),
        ("n=4096 extent=2999", ar, ai, 4096, 2999),
    ]
    max_abs = 0.0
    for label, xr, xi, n, extent in cases:
        got = hemv_planar(xr, xi, vr[:n], vi[:n], extent=extent)
        c = n if extent is None else extent
        want = hemv_planar_plain(xr[:c, :c], xi[:c, :c], vr[:c], vi[:c])
        dense = torch.complex(xr[:c, :c], xi[:c, :c]) @ torch.complex(vr[:c], vi[:c])
        torch.cuda.synchronize()
        scale = float(dense.abs().max())
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        errs_d = [float((g - w).abs().max()) for g, w in zip(got, (dense.real, dense.imag))]
        max_abs = max(max_abs, *errs)
        log(f"K3 {label}: rel_err vs plain {max(errs) / scale:.2e}, "
            f"vs dense complex64 a @ v {max(errs_d) / scale:.2e}")
        if not max(errs) <= MV_TOL * scale or not max(errs_d) <= MV_TOL * scale:
            raise RuntimeError(f"K3 disagrees with its plain version at {label}")
    ms = device_ms(lambda: hemv_planar(ar, ai, vr, vi), iters=100)
    plain_ms = device_ms(lambda: hemv_planar_plain(ar, ai, vr, vi), iters=2)
    ac, vc = torch.complex(ar, ai), torch.complex(vr, vi)
    with true_fp32():
        library_ms = device_ms(lambda: torch.mv(ac, vc), iters=100)
    bound_ms, bound_by = _mv_bound(4096, 2)
    log(f"K3 times at n=4096 fp32: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"library (torch.mv, complex64, full matrix) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")

    # the path that launches K3: one full panel of the planar column loop
    mb, nb = 4096, 32
    outs = {}
    for use_pallas in (False, True):
        pr, pi = ar.clone(), ai.clone()
        d, e, taur, taui = (torch.zeros(mb, dtype=torch.float32, device=dev) for _ in range(4))
        hemv_planar.launches = 0
        with true_fp32():
            panels = _panel_columns_planar(pr, pi, d, e, taur, taui, mb, nb,
                                           use_pallas=use_pallas)
        torch.cuda.synchronize()
        outs[use_pallas] = (*panels, pr[:, mb - nb:], pi[:, mb - nb:], d, e, taur, taui)
        launches = hemv_planar.launches
        if launches != (nb if use_pallas else 0):
            raise RuntimeError(f"K3 launches in one panel: {launches}, want "
                               f"{nb if use_pallas else 0} (use_pallas={use_pallas})")
    names = ["vr", "vi", "wr", "wi", "colr", "coli", "d", "e", "taur", "taui"]
    errs = [rel_err(g, w)[0] for g, w in zip(outs[True], outs[False])]
    log(f"K3 panel mb={mb} pe={mb}: launches {launches}, rel_err kernel path vs "
        "matmul path " + " ".join(f"{n}={x:.1e}" for n, x in zip(names, errs)))
    if not max(errs) <= K2_TOL:
        raise RuntimeError("the planar column loop with K3 disagrees with the matmul path")
    return {
        "name": "hemv_planar", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/symv.cu",
        "replaces": "eigensolver_gpu_tpu/ops/hemv_pallas.py:70",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "launches": launches,
    }


def _timed_once(torch, fn):
    """(result, ms) of one call, bracketed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _k5_work(m, b, rb, itemsize):
    """The panel read once, r, v, tau and T written once; per column the
    norm, the scaling, v^T P and the rank-1 update of the columns before
    it; then the gram and the larft recurrence."""
    nbytes = itemsize * (3 * m * b + b + b * b)
    flops = 0
    for j in range(b):
        top = rb + j
        flops += 2 * top + top + 4 * (top + 1) * j
    flops += 2 * (rb + b) * b * b + 2 * b * b * b // 3
    return nbytes, flops


def check_k5(torch):
    import numpy as np

    from eigensolver_gpu_torch.ops.ql_panel import ql_panel, ql_panel_plain
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev = "cuda"
    rng = np.random.default_rng(5)
    big = torch.tensor(rng.standard_normal((4096, 4096)), device=dev)
    big32 = big.float()
    trivial = big32[:128, :16].clone()
    trivial[: 64 + 15, 15] = 0.0  # last column zero above its pivot
    cases = [  # (label, panel, rows_below, tolerance)
        ("(4096, 32) rb=4032", big32[:, :32].contiguous(), 4096 - 64, K5_TOL),
        ("(4096, 32) rb=4032, column slice of 4096^2", big32[:, 4032:4064], 4096 - 64, K5_TOL),
        ("(2048, 32) rb=1984, slice of a leading block", big32[:2048, 2016:2048], 1984, K5_TOL),
        ("(1000, 32) rb=936", big32[:1000, 100:132], 936, K5_TOL),
        ("(1000, 24) rb=500", big32[:1000, 7:31], 500, K5_TOL),
        ("(128, 16) rb=64 trivial column", trivial, 64, K5_TOL),
        ("(1024, 32) rb=960 fp64", big[:1024, 64:96], 960, K5_TOL64),
    ]
    names = ["r_panel", "v", "tau", "t"]
    max_abs = 0.0
    for label, p, rb, tol in cases:
        got = ql_panel(p, rb)
        want = ql_panel_plain(p, rb)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if tol == K5_TOL:
            max_abs = max(max_abs, max(e[1] for e in errs))
        log(f"K5 {label}: rel_err " + " ".join(f"{n}={e[0]:.1e}" for n, e in zip(names, errs)))
        if any(g.shape != w.shape for g, w in zip(got, want)) or not max(e[0] for e in errs) <= tol:
            raise RuntimeError(f"K5 disagrees with its plain version at {label}")
        if "trivial" in label:
            b = p.shape[1]
            if float(got[2][b - 1]) != 0.0 or float(got[1][:, b - 1].abs().max()) != 0.0 \
                    or not torch.equal(got[0][:, b - 1], p[:, b - 1]):
                raise RuntimeError("K5 trivial column: tau, v or the column break the contract")
    p, rb = cases[1][1], cases[1][2]
    if not all(torch.equal(x, y) for x, y in zip(ql_panel(p, rb), ql_panel(p, rb))):
        raise RuntimeError("K5 is not reproducible from run to run")
    ms = device_ms(lambda: ql_panel(p, rb), iters=20)
    plain_ms = device_ms(lambda: ql_panel_plain(p, rb), iters=2)
    bound_ms, bound_by = bound(*_k5_work(4096, 32, rb, 4))
    log(f"K5 times at (4096, 32) rb={rb} fp32: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}); no single library call returns a QL panel "
        "with its T (library_ms null)")
    return {
        "name": "ql_panel", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/ql_panel.cu",
        "replaces": "eigensolver_gpu_tpu/ops/ql_panel_pallas.py:287",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _random_band(torch, n, b, seed, dtype):
    """Lower band storage (n, 2b) of a random symmetric matrix of half-width
    b, and the same in scipy's lower banded form (b + 1, n)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    band = np.zeros((n, 2 * b))
    band[:, : b + 1] = rng.standard_normal((n, b + 1))
    j, d = np.arange(n)[:, None], np.arange(2 * b)[None, :]
    band[j + d >= n] = 0.0
    band = band.astype(np.float32 if dtype == torch.float32 else np.float64)
    sci = np.ascontiguousarray(band[:, : b + 1].T, dtype=np.float64)
    return torch.tensor(band, device="cuda"), sci


def _k7_work(n, b, itemsize):
    """The band read and written once, the reflector store written once;
    per active window the reflector, three b x b products and three
    rank-1/rank-2 tile updates."""
    from eigensolver_gpu_torch.ops.sb2st import chase_dims

    s_slots, t_total, t3 = chase_dims(n, b)
    windows = 0
    for t in range(t_total):
        vmax, k0 = divmod(t, 3)
        room = n - 3 - vmax - k0 * b
        if room >= 0:
            s_hi = min(room // (3 * b - 1), vmax, s_slots - 1)
            windows += max(0, s_hi - max(vmax - (n - 3), 0) + 1)
    nbytes = itemsize * (2 * n * 2 * b + t3 * s_slots * (b + 1))
    return nbytes, windows * (12 * b * b + 8 * b), windows


def check_k7(torch):
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.sb2st import apply_q2, band_to_dense, bulge_chase
    from eigensolver_gpu_torch.utils.timer import device_ms

    names = ["d", "e", "vt", "taut"]
    record = {}
    for n, b, dtype in ((100, 6, torch.float32), (100, 6, torch.float64),
                        (4096, BAND, torch.float32), (4096, BAND, torch.float64)):
        f32 = dtype == torch.float32
        label = f"n={n} b={b} {'fp32' if f32 else 'fp64'}"
        band, sci = _random_band(torch, n, b, 7, dtype)
        got = bulge_chase_kernel(band, b)
        want, plain_ms = _timed_once(torch, lambda: bulge_chase(band, b))
        if not all(torch.equal(x, y) for x, y in zip(got, bulge_chase_kernel(band, b))):
            raise RuntimeError(f"K7 is not reproducible from run to run at {label}")
        if any(g.shape != w.shape for g, w in zip(got, want)):
            raise RuntimeError(f"K7 output shapes differ from the plain version at {label}")
        # a reflector whose tau is 0 is read by nobody: compare the active
        # ones. In fp64 everything is held elementwise. In fp32 the entries
        # of a tridiagonal reduction are ill-conditioned functions of the
        # band towards the rows reduced last, and where a pivot alpha lies
        # within the drift of 0 its beta takes the other sign (from there on
        # e and v differ by a diagonal +-1 similarity). So in fp32 the first
        # K7_HEAD sweeps are held elementwise in d, |e|, |v| and tau, and the
        # whole output through what it must satisfy: the spectrum of (d, e)
        # is the band matrix's, and Q2 T Q2^T (Q2 from the plain replay of
        # the kernel's reflectors) gives the band matrix back.
        act = (want[3] != 0)[..., None]
        full = [rel_err(g, w)[0] for g, w in
                ((got[0], want[0]), (got[1], want[1]), (got[2] * act, want[2] * act),
                 (got[3], want[3]))]
        if f32:
            h = min(K7_HEAD, n - 1)
            pairs = [(got[0][:h], want[0][:h]), (got[1][:h].abs(), want[1][:h].abs()),
                     ((got[2] * act)[: 3 * h].abs(), (want[2] * act)[: 3 * h].abs()),
                     (got[3][: 3 * h], want[3][: 3 * h])]
            errs = [rel_err(g, w) for g, w in pairs]
        else:
            errs = [rel_err(g, w) for g, w in
                    ((got[0], want[0]), (got[1], want[1]), (got[2] * act, want[2] * act),
                     (got[3], want[3]))]
        w_band = scipy.linalg.eigvals_banded(sci, lower=True)
        spec = []
        for d, e in (got[:2], want[:2]):
            d, e = d.double().cpu().numpy(), e.double().cpu().numpy()
            w = scipy.linalg.eigvalsh_tridiagonal(d, e)
            spec.append(float(np.abs(w - w_band).max() / np.abs(w_band).max()))
        dense = band_to_dense(band, b)
        sim = []
        for d, e, vt, taut in (got, want):
            q2 = apply_q2(vt, taut, torch.eye(n, dtype=dtype, device="cuda"), n, b, g=b)
            tri = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
            sim.append(rel_err(q2 @ tri @ q2.T, dense)[0])
        log(f"K7 {label}: rel_err vs plain " + " ".join(
            f"{k}={x[0]:.1e}" for k, x in zip(names, errs))
            + (f" (first {h} sweeps, |e| and |vt|; whole arrays, signed: " + " ".join(
                f"{k}={x:.1e}" for k, x in zip(names, full)) + ")" if f32 else "")
            + f"; spectrum vs the band matrix: kernel {spec[0]:.1e}, plain {spec[1]:.1e}"
            + f"; Q2 T Q2^T vs the band matrix: kernel {sim[0]:.1e}, plain {sim[1]:.1e}")
        tol, spec_tol = (K7_TOL, K7_SPEC_TOL) if f32 else (K7_TOL64, K7_SPEC_TOL64)
        if not max(x[0] for x in errs) <= tol or not spec[0] <= spec_tol or not sim[0] <= spec_tol:
            raise RuntimeError(f"K7 disagrees with its plain version at {label}")
        if n == 4096:
            ms = device_ms(lambda: bulge_chase_kernel(band, b), iters=3)
            nbytes, flops, windows = _k7_work(n, b, 4 if f32 else 8)
            bound_ms, bound_by = bound(nbytes, flops)
            log(f"K7 times at {label}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {windows} windows); no single library call "
                "chases a band to tridiagonal (library_ms null)")
            if f32:
                record = {
                    "name": "bulge_chase_kernel", "route": "cuda",
                    "source": "eigensolver_gpu_torch/csrc/chase.cu",
                    "replaces": "eigensolver_gpu_tpu/ops/chase_pallas.py:929",
                    "max_abs_err": max(x[1] for x in errs), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                }
    return record


def _k9_work(n, m, b, g, itemsize):
    """Reflectors and y read once, y written once; per valid window the
    l_win x l_win product with its m columns, and forming the window's
    orthogonal (V^T V, the g x g inverse, T^-1 V^T, V (T^-1 V^T))."""
    from eigensolver_gpu_torch.ops.replay import _geometry, _wave_gather
    from eigensolver_gpu_torch.ops.sb2st import chase_dims

    geo = _geometry(n, b, g)
    valid, _ = _wave_gather(geo, n, b, g, geo["n_groups"] * g + g, geo["kmax"] + 2)
    windows = int(valid.sum())
    l_win = geo["l_win"]
    s_slots, _, t3 = chase_dims(n, b)
    nbytes = itemsize * (t3 * s_slots * (b + 1) + 2 * n * m)
    per_q = 2 * l_win * g * g + g * g * g // 3 + 2 * g * g * l_win + 2 * l_win * l_win * g
    return nbytes, windows * (2 * l_win * l_win * m + per_q), windows


def check_k9(torch):
    import numpy as np

    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, window_qs
    from eigensolver_gpu_torch.ops.sb2st import apply_q2
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(9)
    max_abs = 0.0
    n, b, g = 4096, BAND, REPLAY_G
    band, _ = _random_band(torch, n, b, 9, torch.float32)
    _, _, vt, taut = bulge_chase_kernel(band, b)
    y_all = torch.tensor(rng.standard_normal((n, 4096)), dtype=torch.float32, device="cuda")
    for m in (512, 100, 4096):
        y = y_all[:, :m]  # a column slice: the wrapper takes any layout
        got = apply_q2_kernel(vt, taut, y, n, b, g=g)
        want = apply_q2(vt, taut, y, n, b, g=g)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        moved = rel_err(want, y)[0]  # the replay is no identity on this input
        max_abs = max(max_abs, err)
        log(f"K9 n={n} b={b} g={g} m={m} fp32: rel_err vs plain {rel:.2e} "
            f"(plain vs its input {moved:.2e})")
        if got.shape != want.shape or not rel <= K9_TOL or not moved > 0.1:
            raise RuntimeError(f"K9 disagrees with its plain version at m={m}")
    if not torch.equal(got, apply_q2_kernel(vt, taut, y, n, b, g=g)):
        raise RuntimeError("K9 is not reproducible from run to run")
    # fp64 instance at the pure-fp64 path's group size g = b, odd sizes
    n64, b64 = 1000, 24
    band64, _ = _random_band(torch, n64, b64, 10, torch.float64)
    _, _, vt64, taut64 = bulge_chase_kernel(band64, b64)
    y64 = torch.tensor(rng.standard_normal((n64, 70)), device="cuda")
    rel64, _ = rel_err(apply_q2_kernel(vt64, taut64, y64, n64, b64, g=b64),
                       apply_q2(vt64, taut64, y64, n64, b64, g=b64))
    log(f"K9 n={n64} b={b64} g={b64} m=70 fp64: rel_err vs plain {rel64:.2e}")
    if not rel64 <= K9_TOL64:
        raise RuntimeError("K9 (fp64) disagrees with its plain version")

    # the main path replays all n columns (the mixed solve refines from the
    # full fp32 basis): time m = 4096
    ms = device_ms(lambda: apply_q2_kernel(vt, taut, y_all, n, b, g=g), iters=3)
    qs_ms = device_ms(lambda: window_qs(vt, taut, n, b, g), iters=3)
    plain_ms = device_ms(lambda: apply_q2(vt, taut, y_all, n, b, g=g), iters=2)
    ms512 = device_ms(lambda: apply_q2_kernel(vt, taut, y_all[:, :512], n, b, g=g), iters=3)
    nbytes, flops, windows = _k9_work(n, 4096, b, g, 4)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"K9 times at n={n} m=4096 fp32: wrapper {ms:.3f} ms (of which window_qs {qs_ms:.3f} ms, "
        f"outside the kernel), at m=512 {ms512:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {windows} windows); no single library call replays "
        "wave-ordered windows (library_ms null)")
    return {
        "name": "apply_q2_kernel", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/replay.cu",
        "replaces": "eigensolver_gpu_tpu/ops/replay_pallas.py:674",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _k6_work(m, b, rb, itemsize):
    """Both planes of the panel read once, of r and v written once, tau and
    T; per column the norm, the complex scaling, v^H P and the rank-1 update
    of the columns before it; then the complex gram and larft recurrence."""
    nbytes = itemsize * 2 * (3 * m * b + b + b * b)
    flops = 0
    for j in range(b):
        top = rb + j
        flops += 4 * top + 6 * top + 16 * (top + 1) * j
    flops += 8 * (rb + b) * b * b + 8 * b * b * b // 3
    return nbytes, flops


def check_k6(torch):
    import numpy as np

    from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar, ql_panel_planar_plain
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev = "cuda"
    rng = np.random.default_rng(6)
    big_r = torch.tensor(rng.standard_normal((4096, 4096)), device=dev)
    big_i = torch.tensor(rng.standard_normal((4096, 4096)), device=dev)
    r32, i32 = big_r.float(), big_i.float()
    tr_r, tr_i = r32[:128, :16].clone(), i32[:128, :16].clone()
    tr_r[: 64 + 15, 15] = 0.0  # last column: zero tail, real pivot (trivial)
    tr_i[: 64 + 16, 15] = 0.0
    tr_r[: 64 + 14, 14] = 0.0  # the one before: zero tail, complex pivot
    tr_i[: 64 + 14, 14] = 0.0
    sl = lambda x, rows, c0, c1: x[:rows, c0:c1]
    cases = [  # (label, real plane, imaginary plane, rows_below, tolerance)
        ("(4096, 32) rb=4032", r32[:, :32].contiguous(), i32[:, :32].contiguous(), 4032, K6_TOL),
        ("(4096, 32) rb=4032, column slices of 4096^2", sl(r32, 4096, 4032, 4064),
         sl(i32, 4096, 4032, 4064), 4032, K6_TOL),
        ("(2048, 32) rb=1984, slices of a leading block", sl(r32, 2048, 2016, 2048),
         sl(i32, 2048, 2016, 2048), 1984, K6_TOL),
        ("(1000, 24) rb=500", sl(r32, 1000, 7, 31), sl(i32, 1000, 7, 31), 500, K6_TOL),
        ("(128, 16) rb=64 trivial and phase-only columns", tr_r, tr_i, 64, K6_TOL),
        ("(1024, 32) rb=960 fp64", sl(big_r, 1024, 64, 96), sl(big_i, 1024, 64, 96), 960,
         K6_TOL64),
    ]
    names = ["pf_r", "pf_i", "v_r", "v_i", "tau_r", "tau_i", "t_r", "t_i"]
    max_abs = 0.0
    for label, pr, pi, rb, tol in cases:
        got = ql_panel_planar(pr, pi, rb)
        want = ql_panel_planar_plain(pr, pi, rb)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if tol == K6_TOL:
            max_abs = max(max_abs, max(e[1] for e in errs))
        log(f"K6 {label}: rel_err " + " ".join(f"{n}={e[0]:.1e}" for n, e in zip(names, errs)))
        if any(g.shape != w.shape for g, w in zip(got, want)) or not max(e[0] for e in errs) <= tol:
            raise RuntimeError(f"K6 disagrees with its plain version at {label}")
        b = pr.shape[1]
        if any(float(got[1][: rb + j + 1, j].abs().max()) != 0.0 for j in range(b)):
            raise RuntimeError(f"K6 left an imaginary part on or above a pivot at {label}")
        if "trivial" in label:
            if float(got[4][b - 1]) != 0.0 or float(got[5][b - 1]) != 0.0 \
                    or float(got[2][:, b - 1].abs().max()) != 0.0 \
                    or not torch.equal(got[0][:, b - 1], pr[:, b - 1]):
                raise RuntimeError("K6 trivial column: tau, v or the column break the contract")
            if float(got[5][b - 2]) == 0.0 or float(got[2][rb + b - 2, b - 2]) != 1.0:
                raise RuntimeError("K6 phase-only column: a complex pivot must give a reflector")
    _, pr, pi, rb, _ = cases[1]
    if not all(torch.equal(x, y) for x, y in zip(ql_panel_planar(pr, pi, rb),
                                                 ql_panel_planar(pr, pi, rb))):
        raise RuntimeError("K6 is not reproducible from run to run")
    ms = device_ms(lambda: ql_panel_planar(pr, pi, rb), iters=20)
    plain_ms = device_ms(lambda: ql_panel_planar_plain(pr, pi, rb), iters=2)
    bound_ms, bound_by = bound(*_k6_work(4096, 32, rb, 4))
    log(f"K6 times at (4096, 32) rb={rb} fp32: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}); no single library call returns a planar QL "
        "panel with its T (library_ms null)")
    return {
        "name": "ql_panel_planar", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/ql_panel_planar.cu",
        "replaces": "eigensolver_gpu_tpu/ops/ql_panel_pallas.py:251",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _random_hband(torch, n, b, seed, dtype):
    """Both lower band planes (n, 2b) of a random Hermitian matrix of
    half-width b (real diagonal), and the same in scipy's lower banded form
    (b + 1, n), complex."""
    import numpy as np

    rng = np.random.default_rng(seed)
    planes = np.zeros((2, n, 2 * b))
    planes[0, :, : b + 1] = rng.standard_normal((n, b + 1))
    planes[1, :, 1 : b + 1] = rng.standard_normal((n, b))
    j, d = np.arange(n)[:, None], np.arange(2 * b)[None, :]
    planes[:, j + d >= n] = 0.0
    planes = planes.astype(np.float32 if dtype == torch.float32 else np.float64)
    sci = np.ascontiguousarray((planes[0] + 1j * planes[1])[:, : b + 1].T, dtype=np.complex128)
    return torch.tensor(planes[0], device="cuda"), torch.tensor(planes[1], device="cuda"), sci


def _hband_dense(torch, band_r, band_i):
    """The Hermitian matrix of two lower band planes, complex128."""
    n, w = band_r.shape
    low = torch.zeros((n, n), dtype=torch.complex128, device=band_r.device)
    for d in range(min(w, n)):
        low += torch.diag(torch.complex(band_r[: n - d, d].double(), band_i[: n - d, d].double()), -d)
    return low + torch.tril(low, -1).conj().T


def _k8_checks(torch, out, band_r, band_i, sci, b):
    """What a whole planar chase must satisfy, whatever its rounding: the
    spectrum of (d, |e|) is the band matrix's, and Q2 (D T D^H) Q2^H (Q2
    from the plain replay of these reflectors, D from phase_normalize)
    gives the band matrix back. Returns the two relative errors."""
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch.ops.sb2st_planar import apply_q2_planar, phase_normalize

    d, e, vt, taut = out
    n = d.shape[0]
    (p_r, p_i), mag = phase_normalize(*e)
    w_band = scipy.linalg.eigvals_banded(sci, lower=True)
    w = scipy.linalg.eigvalsh_tridiagonal(d.double().cpu().numpy(), mag.double().cpu().numpy())
    spec = float(np.abs(w - w_band).max() / np.abs(w_band).max())
    eye = torch.eye(n, dtype=d.dtype, device="cuda")
    q2 = torch.complex(*apply_q2_planar(vt, taut, (eye, torch.zeros_like(eye)), n, b, g=b))
    q2d = q2.to(torch.complex128) * torch.complex(p_r.double(), p_i.double())[None, :]
    tri = torch.diag(d.double()) + torch.diag(mag.double(), 1) + torch.diag(mag.double(), -1)
    dense = _hband_dense(torch, band_r, band_i)
    sim = float((q2d @ tri.to(torch.complex128) @ q2d.conj().T - dense).abs().max()
                / dense.abs().max())
    return spec, sim


def check_k8(torch):
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.sb2st_planar import bulge_chase_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    flat = lambda o: [o[0], o[1][0], o[1][1], o[2][0], o[2][1], o[3][0], o[3][1]]
    record = {}
    # the plain chase costs about a millisecond a timestep: it runs at
    # n = 4096 once, in the main path's type; the fp64 instance is held at
    # N_K8_HELD and checked through spectrum and similarity at n = 4096
    for n, b, dtype, with_plain in (
            (100, 6, torch.float32, True), (100, 6, torch.float64, True),
            (N_K8_HELD, BAND, torch.float64, True), (4096, BAND, torch.float64, False),
            (4096, BAND, torch.float32, True)):
        f32 = dtype == torch.float32
        label = f"n={n} b={b} {'fp32' if f32 else 'fp64'}"
        band_r, band_i, sci = _random_hband(torch, n, b, 8, dtype)
        got = bulge_chase_planar_kernel(band_r, band_i, b)
        if not all(torch.equal(x, y) for x, y in
                   zip(flat(got), flat(bulge_chase_planar_kernel(band_r, band_i, b)))):
            raise RuntimeError(f"K8 is not reproducible from run to run at {label}")
        spec, sim = _k8_checks(torch, got, band_r, band_i, sci, b)
        tol, spec_tol = (K8_TOL, K8_SPEC_TOL) if f32 else (K8_TOL64, K8_SPEC_TOL64)
        msg = f"K8 {label}: spectrum of (d, |e|) vs the band matrix {spec:.1e}, " \
              f"Q2 (D T D^H) Q2^H vs the band matrix {sim:.1e}"
        errs = []
        if with_plain:
            want, plain_ms = _timed_once(torch, lambda: bulge_chase_planar(band_r, band_i, b))
            if any(g.shape != w.shape for g, w in zip(flat(got), flat(want))):
                raise RuntimeError(f"K8 output shapes differ from the plain version at {label}")
            act = ((want[3][0] != 0) | (want[3][1] != 0))[..., None]
            g, w = flat(got), flat(want)
            for k in (3, 4):  # a reflector whose tau is 0 is read by nobody
                g[k], w[k] = g[k] * act, w[k] * act
            full = [rel_err(x, y)[0] for x, y in zip(g, w)]
            if f32:
                # moduli on the first sweeps: d, |e|, |v|, |tau|
                h = min(K7_HEAD, n - 1)
                mod = lambda o: [o[0][:h], torch.hypot(o[1], o[2])[:h],
                                 torch.hypot(o[3], o[4])[: 3 * h], torch.hypot(o[5], o[6])[: 3 * h]]
                errs = [rel_err(x, y) for x, y in zip(mod(g), mod(w))]
                msg += (f"; rel_err vs plain on the first {h} sweeps d={errs[0][0]:.1e} "
                        f"|e|={errs[1][0]:.1e} |vt|={errs[2][0]:.1e} |taut|={errs[3][0]:.1e}")
            else:
                errs = [rel_err(x, y) for x, y in zip(g, w)]
            msg += "; whole arrays, both planes: " + " ".join(
                f"{k}={x:.1e}" for k, x in zip(("d", "e_r", "e_i", "vt_r", "vt_i", "taut_r",
                                                "taut_i"), full))
            wspec, wsim = _k8_checks(torch, want, band_r, band_i, sci, b)
            msg += f"; plain version: spectrum {wspec:.1e}, similarity {wsim:.1e}"
        log(msg)
        if not spec <= spec_tol or not sim <= spec_tol \
                or (errs and not max(x[0] for x in errs) <= tol):
            raise RuntimeError(f"K8 disagrees with its plain version at {label}")
        if n == 4096:
            ms = device_ms(lambda: bulge_chase_planar_kernel(band_r, band_i, b), iters=3)
            nbytes, flops, windows = _k7_work(n, b, 4 if f32 else 8)
            bound_ms, bound_by = bound(2 * nbytes, 4 * flops)  # two planes, complex products
            log(f"K8 times at {label}: kernel {ms:.3f} ms"
                + (f", plain {plain_ms:.1f} ms" if with_plain else "")
                + f", bound {bound_ms:.4f} ms ({bound_by}; {windows} windows); no single "
                "library call chases a Hermitian band to tridiagonal (library_ms null)")
            if f32:
                record = {
                    "name": "bulge_chase_planar_kernel", "route": "cuda",
                    "source": "eigensolver_gpu_torch/csrc/chase_planar.cu",
                    "replaces": "eigensolver_gpu_tpu/ops/chase_pallas.py:804",
                    "max_abs_err": max(x[1] for x in errs), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                }
    return record


def check_k10(torch):
    import numpy as np

    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel, window_qs_planar
    from eigensolver_gpu_torch.ops.sb2st_planar import apply_q2_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(10)
    max_abs = 0.0
    n, b, g = 4096, BAND, REPLAY_G
    band_r, band_i, _ = _random_hband(torch, n, b, 10, torch.float32)
    _, _, vt, taut = bulge_chase_planar_kernel(band_r, band_i, b)
    y_all = torch.tensor(rng.standard_normal((2, n, 4096)), dtype=torch.float32, device="cuda")
    for m in (512, 100, 4096):
        y = (y_all[0, :, :m], y_all[1, :, :m])  # column slices: the wrapper takes any layout
        got = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
        want = apply_q2_planar(vt, taut, y, n, b, g=g)
        torch.cuda.synchronize()
        errs = [rel_err(x, w) for x, w in zip(got, want)]
        moved = min(rel_err(w, y0)[0] for w, y0 in zip(want, y))  # no identity on this input
        max_abs = max(max_abs, max(e[1] for e in errs))
        log(f"K10 n={n} b={b} g={g} m={m} fp32: rel_err vs plain re={errs[0][0]:.2e} "
            f"im={errs[1][0]:.2e} (plain vs its input {moved:.2e})")
        if any(x.shape != w.shape for x, w in zip(got, want)) \
                or not max(e[0] for e in errs) <= K10_TOL or not moved > 0.1:
            raise RuntimeError(f"K10 disagrees with its plain version at m={m}")
    again = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise RuntimeError("K10 is not reproducible from run to run")
    del got, want, again
    # fp64 instance at the pure-fp64 path's group size g = b, odd sizes
    n64, b64 = 1000, 24
    r64, i64, _ = _random_hband(torch, n64, b64, 11, torch.float64)
    _, _, vt64, taut64 = bulge_chase_planar_kernel(r64, i64, b64)
    y64 = tuple(torch.tensor(rng.standard_normal((n64, 70)), device="cuda") for _ in range(2))
    rel64 = max(rel_err(x, w)[0] for x, w in zip(
        apply_q2_planar_kernel(vt64, taut64, y64, n64, b64, g=b64),
        apply_q2_planar(vt64, taut64, y64, n64, b64, g=b64)))
    log(f"K10 n={n64} b={b64} g={b64} m=70 fp64: rel_err vs plain {rel64:.2e}")
    if not rel64 <= K10_TOL64:
        raise RuntimeError("K10 (fp64) disagrees with its plain version")

    # the main path replays all n columns (the mixed solve refines from the
    # full fp32 basis): time m = 4096
    y = (y_all[0], y_all[1])
    ms = device_ms(lambda: apply_q2_planar_kernel(vt, taut, y, n, b, g=g), iters=3)
    qs_ms = device_ms(lambda: window_qs_planar(vt, taut, n, b, g), iters=3)
    plain_ms = device_ms(lambda: apply_q2_planar(vt, taut, y, n, b, g=g), iters=2)
    nbytes, flops, windows = _k9_work(n, 4096, b, g, 4)
    bound_ms, bound_by = bound(2 * nbytes, 4 * flops)  # two planes, complex products
    log(f"K10 times at n={n} m=4096 fp32: wrapper {ms:.3f} ms (of which window_qs_planar "
        f"{qs_ms:.3f} ms, outside the kernel), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {windows} windows); no single library call replays wave-ordered "
        "windows (library_ms null)")
    return {
        "name": "apply_q2_planar_kernel", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/replay_planar.cu",
        "replaces": "eigensolver_gpu_tpu/ops/replay_pallas.py:560",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _device_residual(torch, args, res):
    """bench.py's residual of the complex problem, in planar arithmetic on
    the device: max_k ||A z_k - w_k B z_k|| / (n * max row 1-norm of A)."""
    ar, ai, br, bi = args
    w, zr, zi = res.w, res.zr, res.zi
    n = ar.shape[0]
    rr = ar @ zr - ai @ zi - (br @ zr - bi @ zi) * w[None, :]
    ri = ar @ zi + ai @ zr - (br @ zi + bi @ zr) * w[None, :]
    r2 = torch.sum(rr * rr + ri * ri, dim=0)
    anorm = torch.max(torch.sum(torch.sqrt(ar * ar + ai * ai), dim=1))
    return float(torch.max(torch.sqrt(r2)) / (n * anorm))


def _breakdown(torch, solve, wall):
    """One solve with synchronizing trace ranges (stage ms), then one under
    torch.profiler: device busy ms (sum of kernel self times), the idle
    share against the unprofiled wall time ``wall``, and the top kernels.
    Returns the stage ms by range name."""
    from torch.profiler import ProfilerActivity, profile

    from eigensolver_gpu_torch.utils import tracing

    tracing.clear()
    tracing.enable(sync=True)
    try:
        solve()
    finally:
        tracing.disable()
    stages = {}
    for name, sec in tracing.timings():
        stages[name] = stages.get(name, 0.0) + sec * 1e3
    tracing.clear()
    # device activity only, read from the raw kineto records: building
    # the profiler's per-op event tree for ~10^5 small ops takes minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    per_kernel = {}  # name -> [ms, count]; one stream, so times add up
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            acc = per_kernel.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    busy = sum(v[0] for v in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    top = ", ".join(f"{k[:48]}={v[0]:.1f}ms/{v[1]}" for k, v in ranked)
    idle = f"{1.0 - busy / wall:.3f}" if busy > 0 else "not measured"
    log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    log(f"  device busy {busy:.1f} ms of {wall:.1f} ms wall, idle share {idle}; top: {top}")
    return stages


def phase_main(torch):
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy
    from eigensolver_gpu_torch.utils.testing import random_hpd_pair
    from eigensolver_gpu_torch.utils.timer import wall_ms

    a, b = random_hpd_pair(N_MAIN, seed=0)
    args = planar_from_numpy(a, b, device="cuda", dtype=torch.float64)
    del a, b
    launches = {}
    for use_pallas, want_k2 in ((False, 0), (True, 64)):
        cfg = SolverConfig(compute_dtype="float32", use_pallas=use_pallas)
        solve = lambda: zhegvdx_planar(*args, il=1, iu=IU_MAIN, cfg=cfg)
        pchol_block_planar.launches = 0
        latrd_panel_planar.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        k1, k2 = pchol_block_planar.launches, latrd_panel_planar.launches
        launches = {"pchol_block_planar": k1, "latrd_panel_planar": k2}
        info = int(res.info)
        resid = _device_residual(torch, args, res)
        finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.zr).all()
                      and torch.isfinite(res.zi).all())
        shapes = (tuple(res.w.shape), tuple(res.zr.shape), tuple(res.zi.shape))
        times = wall_ms(solve, iters=1)
        log(f"main use_pallas={use_pallas}: n={N_MAIN} iu={IU_MAIN} info={info} "
            f"residual={resid:.3e} first={first_ms:.1f} ms timed={[round(x, 1) for x in times]} ms "
            f"launches K1={k1} K2={k2} peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if info != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(f"main path wrong: info={info} finite={finite} residual={resid}")
        if shapes != ((IU_MAIN,), (N_MAIN, IU_MAIN), (N_MAIN, IU_MAIN)):
            raise RuntimeError(f"main path shapes {shapes}")
        if k1 != N_MAIN // 128 or k2 != want_k2:
            raise RuntimeError(f"launch counts K1={k1} K2={k2}, want {N_MAIN // 128} and {want_k2}")
        _breakdown(torch, solve, min(times))
    return launches


def phase_reference(torch):
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar_host
    from eigensolver_gpu_torch.utils.testing import ge_residual, random_hpd_pair

    a, b = random_hpd_pair(N_REF, seed=1)
    cfg = SolverConfig(compute_dtype="float32", use_pallas=True)
    res = zhegvdx_planar_host(a, b, il=1, iu=IU_REF, cfg=cfg, device="cuda")
    w = res.w.cpu().numpy()
    z = res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True, subset_by_index=[0, IU_REF - 1])
    err = float(np.abs(w - w_ref).max())
    resid = ge_residual(a, b, w, z)
    log(f"reference n={N_REF} iu={IU_REF}: max |w - scipy| = {err:.3e} "
        f"(tol {1e-10 * N_REF:.1e}), ge_residual = {resid:.3e}, info={int(res.info)}")
    if not err <= 1e-10 * N_REF or int(res.info) != 0 or not resid < 1e-12:
        raise RuntimeError("reference comparison failed")
    # pure fp64 through the two-stage reduction: the fp64 instances of K6,
    # K8 and K10 (replay group g = band)
    res = zhegvdx_planar_host(a, b, il=1, iu=IU_REF, device="cuda",
                              cfg=SolverConfig(tridiag_mode="two"))
    w = res.w.cpu().numpy()
    z = res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
    err = float(np.abs(w - w_ref).max())
    resid = ge_residual(a, b, w, z)
    log(f"reference n={N_REF} iu={IU_REF} fp64 tridiag_mode=two: max |w - scipy| = {err:.3e} "
        f"(tol {1e-10 * N_REF:.1e}), ge_residual = {resid:.3e}, info={int(res.info)}")
    if not err <= 1e-10 * N_REF or int(res.info) != 0 or not resid < 1e-12:
        raise RuntimeError("reference comparison failed (fp64, tridiag_mode=two)")


def phase_main_real(torch):
    """dsygvdx n=4096 il=1..iu=512 mp from fp64 operands on the card, with
    use_pallas False then True; returns K4's launches of the last solve."""
    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.ops.symv import symv
    from eigensolver_gpu_torch.utils.convert import dense_from_numpy
    from eigensolver_gpu_torch.utils.testing import random_spd_pair
    from eigensolver_gpu_torch.utils.timer import wall_ms

    n, iu = N_REAL, IU_REAL
    a, b = dense_from_numpy(*random_spd_pair(n, seed=0), device="cuda", dtype=torch.float64)
    anorm = torch.max(torch.sum(a.abs(), dim=1))
    # syevdx runs sytrd with 256-row buckets; the symv kernel serves the
    # 512-aligned ones: 8 buckets x 8 panels x 32 columns
    want_on = (n // 512) * (256 // 32) * 32
    k4 = 0
    for use_pallas, want_k4 in ((False, 0), (True, want_on)):
        cfg = SolverConfig(compute_dtype="float32", use_pallas=use_pallas)
        solve = lambda: dsygvdx(a, b, il=1, iu=iu, cfg=cfg)
        symv.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        k4 = symv.launches
        info = int(res.info)
        r = a @ res.z - (b @ res.z) * res.w[None, :]
        resid = float(torch.max(torch.linalg.vector_norm(r, dim=0)) / (n * anorm))
        finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.z).all())
        shapes = (tuple(res.w.shape), tuple(res.z.shape))
        times = wall_ms(solve, iters=1)
        log(f"main real use_pallas={use_pallas}: n={n} iu={iu} info={info} "
            f"residual={resid:.3e} first={first_ms:.1f} ms timed={[round(x, 1) for x in times]} ms "
            f"launches K4={k4} peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if info != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(f"real path wrong: info={info} finite={finite} residual={resid}")
        if shapes != ((iu,), (n, iu)) or res.w.dtype != torch.float64:
            raise RuntimeError(f"real path shapes {shapes} dtype {res.w.dtype}")
        if k4 != want_k4:
            raise RuntimeError(f"launch count K4={k4}, want {want_k4}")
        stages = _breakdown(torch, solve, min(times))
        # the fp32 pipeline's sygvdx range holds Cholesky, sygst, syevdx
        # and the phase-4 solve; syevdx holds sytrd, stedc and unmtr
        log(f"  Cholesky + sygst + phase 4: {stages['sygvdx'] - stages['syevdx']:.1f} ms")
    return k4


def phase_main_real_two(torch):
    """dsygvdx n=4096 il=1..iu=512 mp with tridiag_mode='two': warm-up + 3
    timed solves through K5, K7 and K9, then one solve by the plain torch
    route (mosaic_kernels=False). Returns the kernels' launches per solve."""
    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel
    from eigensolver_gpu_torch.utils import tracing
    from eigensolver_gpu_torch.utils.convert import dense_from_numpy
    from eigensolver_gpu_torch.utils.testing import random_spd_pair
    from eigensolver_gpu_torch.utils.timer import wall_ms

    n, iu = N_REAL, IU_REAL
    a, b = dense_from_numpy(*random_spd_pair(n, seed=0), device="cuda", dtype=torch.float64)
    anorm = torch.max(torch.sum(a.abs(), dim=1))

    def check(res, what):
        r = a @ res.z - (b @ res.z) * res.w[None, :]
        resid = float(torch.max(torch.linalg.vector_norm(r, dim=0)) / (n * anorm))
        finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.z).all())
        if int(res.info) != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(
                f"{what} wrong: info={int(res.info)} finite={finite} residual={resid}")
        shapes = (tuple(res.w.shape), tuple(res.z.shape))
        if shapes != ((iu,), (n, iu)) or res.w.dtype != torch.float64:
            raise RuntimeError(f"{what} shapes {shapes} dtype {res.w.dtype}")
        return resid

    cfg = SolverConfig(compute_dtype="float32", tridiag_mode="two")
    solve = lambda: dsygvdx(a, b, il=1, iu=iu, cfg=cfg)
    wrappers = (ql_panel, bulge_chase_kernel, apply_q2_kernel)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, first_ms = _timed_once(torch, solve)
    counts = {fn.__name__: fn.launches for fn in wrappers}
    resid = check(res, "two-stage real path")
    times = wall_ms(solve, iters=3)
    log(f"main real two-stage mosaic_kernels=True: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"first={first_ms:.1f} ms timed={[round(x, 1) for x in times]} ms launches "
        f"K5={counts['ql_panel']} K7={counts['bulge_chase_kernel']} K9={counts['apply_q2_kernel']} "
        f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"ql_panel": n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
    if counts != want:
        raise RuntimeError(f"launch counts {counts}, want {want}")
    stages = _breakdown(torch, solve, sorted(times)[1])
    log(f"  Cholesky + sygst + phase 4: {stages['sygvdx'] - stages['syevdx']:.1f} ms")

    # the plain torch route, one solve, with synchronizing ranges
    cfg_plain = SolverConfig(compute_dtype="float32", tridiag_mode="two", mosaic_kernels=False)
    for fn in wrappers:
        fn.launches = 0
    tracing.clear()
    tracing.enable(sync=True)
    try:
        res, plain_ms = _timed_once(torch, lambda: dsygvdx(a, b, il=1, iu=iu, cfg=cfg_plain))
    finally:
        tracing.disable()
    stages = {}
    for name, sec in tracing.timings():
        stages[name] = stages.get(name, 0.0) + sec * 1e3
    tracing.clear()
    resid = check(res, "two-stage real path (plain route)")
    if any(fn.launches for fn in wrappers):
        raise RuntimeError("mosaic_kernels=False launched a kernel of the two-stage path")
    log(f"main real two-stage mosaic_kernels=False: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"one solve with synchronizing ranges {plain_ms:.1f} ms")
    log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    return counts


def phase_main_planar_two(torch):
    """zhegvdx n=4096 il=1..iu=1024 mp with tridiag_mode='two': one solve that
    counts launches, 3 timed solves through K1, K6, K8 and K10, the stage
    breakdown; then one n=1024 solve by the plain torch route
    (mosaic_kernels=False), which must launch none of them. Returns the
    kernels' launches per solve."""
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel
    from eigensolver_gpu_torch.utils import tracing
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy
    from eigensolver_gpu_torch.utils.testing import random_hpd_pair
    from eigensolver_gpu_torch.utils.timer import wall_ms

    wrappers = (pchol_block_planar, latrd_panel_planar, ql_panel_planar,
                bulge_chase_planar_kernel, apply_q2_planar_kernel)

    def check(args, res, n, iu, what):
        resid = _device_residual(torch, args, res)
        finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.zr).all()
                      and torch.isfinite(res.zi).all())
        if int(res.info) != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(
                f"{what} wrong: info={int(res.info)} finite={finite} residual={resid}")
        shapes = (tuple(res.w.shape), tuple(res.zr.shape), tuple(res.zi.shape))
        if shapes != ((iu,), (n, iu), (n, iu)) or res.w.dtype != torch.float64 \
                or res.zr.dtype != torch.float64:
            raise RuntimeError(f"{what} shapes {shapes} dtype {res.w.dtype}")
        return resid

    n, iu = N_MAIN, IU_MAIN
    args = planar_from_numpy(*random_hpd_pair(n, seed=0), device="cuda", dtype=torch.float64)
    cfg = SolverConfig(compute_dtype="float32", tridiag_mode="two")
    solve = lambda: zhegvdx_planar(*args, il=1, iu=iu, cfg=cfg)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, first_ms = _timed_once(torch, solve)
    counts = {fn.__name__: fn.launches for fn in wrappers}
    resid = check(args, res, n, iu, "planar two-stage path")
    times = wall_ms(solve, iters=3)
    log(f"main planar two-stage mosaic_kernels=True: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"first={first_ms:.1f} ms timed={[round(x, 1) for x in times]} ms launches "
        f"K1={counts['pchol_block_planar']} K2={counts['latrd_panel_planar']} "
        f"K6={counts['ql_panel_planar']} K8={counts['bulge_chase_planar_kernel']} "
        f"K10={counts['apply_q2_planar_kernel']} "
        f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"pchol_block_planar": n // 128, "latrd_panel_planar": 0,
            "ql_panel_planar": n // BAND - 1, "bulge_chase_planar_kernel": 1,
            "apply_q2_planar_kernel": 1}
    if counts != want:
        raise RuntimeError(f"launch counts {counts}, want {want}")
    _breakdown(torch, solve, sorted(times)[1])
    del args, res

    # the plain torch route, one solve, with synchronizing ranges
    n, iu = N_PLAIN_ROUTE, N_PLAIN_ROUTE // 4
    args = planar_from_numpy(*random_hpd_pair(n, seed=2), device="cuda", dtype=torch.float64)
    cfg_plain = SolverConfig(compute_dtype="float32", tridiag_mode="two", mosaic_kernels=False)
    for fn in wrappers:
        fn.launches = 0
    tracing.clear()
    tracing.enable(sync=True)
    try:
        res, plain_ms = _timed_once(
            torch, lambda: zhegvdx_planar(*args, il=1, iu=iu, cfg=cfg_plain))
    finally:
        tracing.disable()
    stages = {}
    for name, sec in tracing.timings():
        stages[name] = stages.get(name, 0.0) + sec * 1e3
    tracing.clear()
    resid = check(args, res, n, iu, "planar two-stage path (plain route)")
    if any(fn.launches for fn in wrappers):
        raise RuntimeError("mosaic_kernels=False launched a kernel of the planar two-stage path: "
                           f"{ {fn.__name__: fn.launches for fn in wrappers} }")
    log(f"main planar two-stage mosaic_kernels=False: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"one solve with synchronizing ranges {plain_ms:.1f} ms, no kernel launched")
    log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    return {k: v for k, v in counts.items() if k in (
        "ql_panel_planar", "bulge_chase_planar_kernel", "apply_q2_planar_kernel")}


def phase_reference_real(torch):
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.utils.testing import ge_residual, random_spd_pair

    n, iu = N_REF_REAL, IU_REF_REAL
    a, b = random_spd_pair(n, seed=1)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True, subset_by_index=[0, iu - 1])
    # pure fp64: the default config (one-stage at this n), then two-stage
    # through the fp64 instances of K5, K7 and K9
    for mode in ("auto", "two"):
        res = dsygvdx(a, b, il=1, iu=iu, device="cuda", cfg=SolverConfig(tridiag_mode=mode))
        w, z = res.w.cpu().numpy(), res.z.cpu().numpy()
        err = float(np.abs(w - w_ref).max())
        resid = ge_residual(a, b, w, z)
        log(f"reference real n={n} iu={iu} fp64 tridiag_mode={mode}: max |w - scipy| = {err:.3e} "
            f"(tol {1e-10 * n:.1e}), ge_residual = {resid:.3e}, info={int(res.info)}")
        if not err <= 1e-10 * n or int(res.info) != 0 or not resid < 1e-12:
            raise RuntimeError(f"real reference comparison failed (tridiag_mode={mode})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import eigensolver_gpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})", file=sys.stderr)
        return 1
    try:
        phase_device(torch)
        phase_build()
        kernels = [check_k1(torch), check_k2(torch), check_k3(torch), check_k4(torch),
                   check_k5(torch), check_k6(torch), check_k7(torch), check_k8(torch),
                   check_k9(torch), check_k10(torch)]
        launches = phase_main(torch)
        phase_reference(torch)
        launches["symv"] = phase_main_real(torch)
        phase_reference_real(torch)
        launches.update(phase_main_real_two(torch))
        launches.update(phase_main_planar_two(torch))
    except Exception:  # noqa: BLE001 -- report and fail the smoke run
        traceback.print_exc()
        return 1
    for k in kernels:
        k.setdefault("launches", launches.get(k["name"]))
        if not k["launches"]:
            print(f"chip_smoke: {k['name']} was never launched on its path", file=sys.stderr)
            return 1
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None and not math.isfinite(k[key]):
                print(f"chip_smoke: non-finite {key} for {k['name']}", file=sys.stderr)
                return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
