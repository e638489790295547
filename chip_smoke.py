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
  3. kernels -- each hand-written kernel against its plain PyTorch
                version on the same inputs on the card, with times of
                kernel, plain version and a library yardstick;
  4. main    -- zhegvdx n=4096, il=1..iu=1024, fp32 pipeline + fp64
                refinement, with use_pallas False (kernel K1) and True
                (K1 and K2): launch counts from one solve, then 3 timed
                solves, residual computed on the device;
  5. reference -- n=1024 eigenvalues against scipy.linalg.eigh.

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
K1_TOL = 1e-4  # relative max error, fp32, different summation order
K2_TOL = 1e-3  # relative max error, fp32 sums of length <= 4096 in another order


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want):
    """(max abs error / max |want|, max abs error)."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale, float(
        (got.float() - want.float()).abs().max()
    )


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
    share against the median unprofiled wall time, and the top kernels."""
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
        times = wall_ms(solve, iters=3)
        log(f"main use_pallas={use_pallas}: n={N_MAIN} iu={IU_MAIN} info={info} "
            f"residual={resid:.3e} first={first_ms:.1f} ms timed={[round(x, 1) for x in times]} ms "
            f"launches K1={k1} K2={k2} peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if info != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(f"main path wrong: info={info} finite={finite} residual={resid}")
        if shapes != ((IU_MAIN,), (N_MAIN, IU_MAIN), (N_MAIN, IU_MAIN)):
            raise RuntimeError(f"main path shapes {shapes}")
        if k1 != N_MAIN // 128 or k2 != want_k2:
            raise RuntimeError(f"launch counts K1={k1} K2={k2}, want {N_MAIN // 128} and {want_k2}")
        _breakdown(torch, solve, sorted(times)[1])
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
        kernels = [check_k1(torch), check_k2(torch)]
        launches = phase_main(torch)
        phase_reference(torch)
    except Exception:  # noqa: BLE001 -- report and fail the smoke run
        traceback.print_exc()
        return 1
    for k in kernels:
        k["launches"] = launches[k["name"]]
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
