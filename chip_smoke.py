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
                and a library yardstick; K1 also on a batch of 64 blocks in
                one launch (each item bit-identical to its unbatched launch);
                K6, K8 and K10 likewise on batches in one launch: 64 at the
                k-point batch's shapes (K6 the (1024, 32) panel, K8 n=1024
                b=32, K10 n=m=1024) with times and bounds, and K6 3 x
                (1100, 16) rb=1000 fp64, K8 2 x n=2400 b=6 fp64 (268 pairs
                on 132 blocks), K10 3 x n=1000 m=1 fp64, each item
                bit-identical to its unbatched launch, one kernel a call;
                K3 also through the planar column
                loop that launches it; K3 and K4 also at the real solve's
                extents on lda=4096 views, n=999 and n=1, with one launch a
                call (profiler), 20 calls with the first call's bits, and
                times with a warm and a cold L2; K2, K3 and K4 likewise on
                batches in one launch: K2 64 x (1024, 1024) at pe=1024 and
                544 and 2 x (4096, 4096), K4 fp32 and fp64 and K3 on 64 x
                n=1024, full and at extent 999, and K3 through a batched
                panel of the column loop, each item bit-identical to its
                unbatched launch, one kernel a call, times and bounds;
  4. main    -- zhegvdx n=4096, il=1..iu=1024, fp32 pipeline + fp64
                refinement, with use_pallas False (kernel K1) and True
                (K1 and K2): launch counts from one solve, then a timed
                solve, residual computed on the device; one K2 launch a
                panel by the profiler;
  5. reference -- n=1024 eigenvalues against scipy.linalg.eigh, mixed
                one-stage, then pure fp64 with tridiag_mode='two' (the
                fp64 instances of K6, K8, K10);
  6. main (real) -- dsygvdx n=4096, il=1..iu=512, fp32 pipeline + fp64
                refinement, with use_pallas False and True (kernel K4 on
                every panel column of the 512-aligned buckets; its device
                total over one solve by the profiler);
  7. reference (real) -- dsygvdx n=1024, iu=64 in pure fp64 (Jacobi
                leaves, exact substitution) against scipy.linalg.eigh,
                one-stage and two-stage (fp64 instances of K5, K7, K9);
  8. main (real, two-stage) -- the same dsygvdx n=4096 solve with
                tridiag_mode='two': sbrd (K5 per panel), bulge chase
                (K7, one launch a solve by the profiler), replay (K9, one
                launch a solve by the profiler) and apply_q1, then one
                n=512 iu=64 solve with mosaic_kernels=False (the plain
                torch route);
  9. main (planar, two-stage) -- the zhegvdx n=4096 iu=1024 solve of
                phase 4 with tridiag_mode='two': psbrd (K6 per panel),
                planar bulge chase (K8), phase normalisation, replay (K10,
                one launch a solve by the profiler; its window-store bytes
                logged) and apply_q1_planar, then one n=512 solve with
                mosaic_kernels=False (no launch of K1, K6, K8, K10);
 10. main (batched) -- the k-point batch: zhegvdx_planar_batched on 64
                distinct pairs random_hpd_pair(1024, seed=k), iu=128, mp
                (chunk 8 runs in phase 14): residual over every item, info, K1
                launches (8 a batched solve, one a block step for all 64
                problems; the profiler too), wall ms a batch and a problem,
                busy ms, idle share and peak memory; items 0 and 63
                against the unbatched solve; a batch of 4 with a non-PD B in
                item 2; then sygvdx_batched on 64 x random_spd_pair(1024),
                iu=64, mp, two items against the unbatched solve; with
                planar_solve_mode='trinv' one batched solve (residual,
                items 0 and 63 against their unbatched 'trinv' solves);
                stedc's sweeps a merge and its compact merges logged for
                the batch, as for the planar two-stage solve of phase 9;
 11. trinv   -- the main problem (zhegvdx n=4096, iu=1024, mp) with
                planar_solve_mode 'trinv' beside 'blockinv' with
                tridiag_mode='two', and 'trinv' one-stage (its 'blockinv'
                twin is phase 4's solve): solve ms, residual, info, K1
                launches (32), peak memory; pcholesky_lower, the three
                solves and ptrinv_lower with its three planar gemms timed
                alone at the solve's shapes;
 12. stedc   -- the tridiagonals of the planar two-stage mp solves of
                random_hpd_pair(4096) and qe_style_pair(4096) (BASELINE
                config 3's clustered spectrum): stedc alone by
                STOP_EVERY, and the n2=4096 top merge with compact=False
                beside compact=True (same eigenvalues within 1e-5
                relative, residuals of one class);
 13. ozaki   -- refine_gevp_planar at the main path's shapes (fp64 A, B,
                the fp32 pipeline's vectors, sel=(0, 1056), w0, extra_max)
                with gemm 'native' beside 'ozaki', and 'native' with
                final_pass=True (B-norms within 1e-12 of 1): ms and
                residual; one ozaki_matmul (4096, 4096) x (4096, 1056)
                against the fp64 product; then utils/roofline.py's rows
                (share of the H100's published ceilings) for that product
                by ozaki_matmul and by torch.matmul in fp64, torch.matmul
                at 8192^2 in fp32 (TF32 off), bf16 and fp64, and a 2 GiB
                device copy; any share above 105 % fails;
 14. main (batched, two-stage) -- run after phase 10: the k-point batch of
                phase 10 with tridiag_mode='two', one batched solve (chunk
                None and 8): info, residual over every item, launches a
                batched solve by the counters and the profiler (K1 8, K6 31,
                K8 1, K10 1), wall ms, stage ms, busy ms, idle share, peak
                memory; items 0, 21, 42, 63 against their unbatched
                two-stage solves, whose mean time times 64 is the
                item-by-item yardstick (the 64 solved in turn took 32-34
                s). The last lines put it beside phase 10's one-stage
                batched solve.
 15. main (batched real, two-stage) -- phase 10's real batch (sygvdx_batched,
                64 x random_spd_pair(1024), iu=64, mp) with
                tridiag_mode='two', one batched solve: info, residual over
                every item, launches (K5 31, K7 1, K9 1; counters and
                kineto), wall ms, stage ms, busy ms, idle share, peak memory;
                items 0, 21, 42, 63 against their unbatched two-stage solves,
                whose mean time times 64 is the item-by-item yardstick. The
                last lines put it beside phase 10's one-stage real batch.
 16. main (embedded) -- the complex embedding at full width, fp64:
                zhegvdx_embedded on the main problem (n=4096, iu=1024; real
                8192, 'auto' two-stage: K5 255, K7 1, K9 1), then
                zhegvdx_embedded_batched on 8 x random_hpd_pair(2048), iu=256
                (8 x 4096 real, one batched two-stage solve), items 0 and 7
                against their unbatched embedded solves: info, residual of
                the complex pairs, launches, wall ms, stage ms (the
                extraction on its own line), busy ms, peak memory.

 17. sharded (tp, one rank) -- sygvdx_sharded over make_mesh(1), a world of
                one NCCL rank (the group's process, a fresh TCP store), at full
                width: BASELINE config 5, random_spd_pair(16384, seed=0) (its
                draws, products formed on the card), iu=2048, mp, two-stage:
                info, residual, wall ms of one solve with synchronizing ranges
                (no warm-up), stage ms, peak memory, launches (K5 511, K7 1, K9
                1; counters zeroed just before, read just after) and the
                collectives by name and stage; then config 2 (n=4096, iu=512)
                sharded beside the unsharded dsygvdx (eigenvalues within 1e-12
                relative), its eigenvalues kept for phase 18.
 18. sharded (two ranks) -- two ranks sharing the card: what NCCL does with
                two ranks on one device (expected: it refuses, "Duplicate GPU
                detected"), then a gloo world of two spawned ranks whose
                collectives parallel/comm.py stages through host buffers:
                sygvdx_sharded n=4096 iu=512 mp two-stage over make_mesh(2)
                (within 1e-12 of phase 17's one-rank solve),
                zhegvdx_planar_batched_sharded on phase 14's 64 x
                random_hpd_pair(1024) (iu=128, mp, two-stage) and
                sygvdx_batched_sharded on phase 15's real batch (iu=64) over
                make_mesh(2, dp=2), 32 items a rank (launches counted on each
                rank: K1 8, K6 31, K8 1, K10 1; K5 31, K7 1, K9 1): info,
                residual over every item, items 0 and 63 against their
                unbatched solves, wall ms of two processes time-sharing one
                card through host-staged collectives (no scaling figure).
 19. main (batched, use_pallas) -- run after phase 15: phase 10's two
                k-point batches with use_pallas=True, each one batched
                solve: the planar one (K1 8, K2 16 launches) and the real
                one (K4 512), each with info, residual over every item,
                launches (counters and kineto), wall ms, stage ms, busy
                ms, idle share, peak memory, and items 0, 21, 42, 63
                against their unbatched use_pallas solves, whose mean time
                times 64 is the item-by-item yardstick; then 8 planar pairs
                with use_pallas=True and tridiag_mode='two' as one batched
                solve (K6 31, K8 1, K10 1). The last lines put them beside
                phase 10's batched solves without use_pallas.
 20. padded (C1) -- run after phase 7: padded solves whose standard-form
                matrix has a small norm, against scipy.linalg.eigh (eigenvalues
                within 1e-10 of the largest selected |lambda|, ge_residual
                below 1e-12, info 0): real n=130 (padded to 160) il=120..130
                and planar n=100 (to 128) il=90..100 with A scaled 1e-4,
                1e-6, 1e-8, mp one-stage with use_pallas=True and mp
                two-stage; planar fp64 one-stage and two-stage at 1e-8; real
                n=1000 (to 1024, where K4's buckets are reached) mp use_pallas
                at 1e-6; one sygvdx_batched and one zhegvdx_planar_batched mp
                two-stage batch with items scaled 1e-6, 1, 1e6; each solve's
                launches by the wrappers' counters (K1, K4, K5-K10; K2 and K4
                where their bucket gates leave them out must show none).

Phase 7 also holds zhegvdx_via_embedding (n=1024, iu=256, fp64) against
scipy.linalg.eigh, and on an exactly degenerate spectrum (96- and 64-fold
clusters, iu=512) for B-orthonormality and rank. Phase 3 also runs K5, K7
and K9 on batches in one launch: 64 at the real k-point batch's shapes (K5
the (1024, 32) panel, K7 n=1024 b=32, K9 n=m=1024) with times and bounds,
and K5 3 x (1100, 16) rb=1000 fp64, K7 2 x n=2400 b=6 fp64 (268 pairs),
K9 3 x n=1000 m=1 fp64, each item bit-identical to its unbatched launch
(K9 on one window store), one kernel a call.

Phases 1 and 2 run in this process; the checks and phases 3 to 20 run in
groups (GROUPS), each in a child process of its own, one after the other;
each group's process is started (it imports) while the group before it
runs, and touches the card only when its turn comes. The run has 1200 s,
the build included; the checks and phases are sized to end well inside
that with one group run twice (see _device_records).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

# keep CUPTI set up between torch.profiler sessions: the smoke profiles some
# thirty times in one process, and after a teardown the profiler sometimes
# caught no device record in any later session of that process
os.environ.setdefault("TEARDOWN_CUPTI", "0")

try:  # the H100's published ceilings (utils/roofline.py); main() fails where the port is missing
    from eigensolver_gpu_torch.utils.roofline import CEILINGS
except ImportError:
    CEILINGS = {}
HBM_BYTES_PER_S = CEILINGS.get("hbm")  # H100 SXM HBM3
L2_BYTES = 50 * 2**20  # H100 SXM L2
FP32_FLOP_PER_S = CEILINGS.get("f32")  # H100 SXM fp32 outside the tensor cores

N_MAIN, IU_MAIN = 4096, 1024
N_REF, IU_REF = 1024, 256
N_REAL, IU_REAL = 4096, 512  # BASELINE config 2
N_REF_REAL, IU_REF_REAL = 1024, 64  # BASELINE config 1
N_BATCHED, IU_BATCHED = 1024, 128  # BASELINE config 4: 64 k-points, iu = n / 8
IU_BATCHED_REAL = 64
# the complex embedding (phase 16): the main problem, then a k-point batch whose
# 2n = 4096 real embeddings take fp64 'auto''s two-stage route
EMBED_BATCH, N_EMBED_BATCHED, IU_EMBED_BATCHED = 8, 2048, 256
K1_TOL = 1e-4  # relative max error, fp32, different summation order
K1_BATCH = 64  # the k-point batch of phase 10
K2_TOL = 1e-3  # relative max error, fp32 sums of length <= 4096 in another order
MV_TOL = 1e-4  # K3, K4 in fp32: sums of length <= 4096 in another order
MV_TOL64 = 1e-12  # K4 in fp64
# the extents of K4's calls in the real one-stage solve run 256..511, 768..1023, ..,
# 3840..4095 on the [:mb, :mb] views of the padded 4096^2 matrix (row stride 4096)
MV_EXTENTS = (256, 511, 1023, 2047, 3071, 4095)
MV_REPEATS = 20  # calls held to the first call's bits
FLUSH_BYTES = 256 * 2**20  # written and read between cold calls: 5x the L2
BAND, REPLAY_G = 32, 96  # SolverConfig defaults of the fp32 two-stage path
K5_TOL = 1e-4  # relative max error, fp32: sums of length <= 4096 in another order
K5_TOL64 = 1e-11
# the earlier designs' times at the timed shapes, for the log only (PERF.md §6: NVIDIA H100
# 80GB HBM3, 700 W, chip_smoke.py of the design's own PR)
K5_ONE_BLOCK_MS = 2.2412
K8_LAUNCH_SEQUENCE_MS = 93.789
K7_LAUNCH_SEQUENCE_MS = 72.997
K10_ONE_LAUNCH_A_WAVE_MS = 92.000  # the wrapper with all 5936 slots formed
K2_LAUNCH_SEQUENCE_MS = 4.234  # 65 launches a panel, mb = 4096
K9_ONE_LAUNCH_A_WAVE_MS = 44.270  # the wrapper with all 5936 slots formed
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
N_PLAIN_ROUTE = 512  # mosaic_kernels=False solves (the eager chase is slow)
SEL_MAIN = (0, IU_MAIN + 32)  # the mixed driver's refined block: iu + refine_margin
OZAKI_ERR = 2.0**-45  # ozaki_matmul's error bound, relative to (|A| |B|)_ij
FINAL_PASS_BNORM_TOL = 1e-12  # refine_gevp_planar(final_pass=True): |x^H B x - 1|
ROOF_N = 8192  # the roofline phase's square matmuls
ROOF_COPY_BYTES = 2 * 2**30  # the roofline phase's device copy
ROOF_MAX_PCT = 105.0  # a share above this means a wrong ceiling or count
MERGE_W_TOL = 1e-5  # compact against full assembly: eigenvalues, relative
STOP_EVERY_TIMED = (1, 2, 4, 8, 36)  # stedc alone; 36 reads the flag only before sweep 0


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


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device(torch):
    log(_smi())
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
    max_abs = 0.0
    # HPD blocks at every width the blocking treats differently (one column,
    # ragged, whole block columns), all four outputs held
    for nb in (1, 31, 32, 33, 100, 128):
        dr, di = _hpd_block(torch, nb, nb, dev)
        got = pchol_block_planar(dr, di)
        want = pchol_block_plain(dr, di)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got[:4], want[:4])]
        max_abs = max(max_abs, max(e[1] for e in errs))
        log(f"K1 hpd nb={nb}: fail={int(got[4])}/{int(want[4])} rel_err ld_r ld_i inv_r inv_i="
            f"{[f'{e[0]:.2e}' for e in errs]}")
        if int(got[4]) != 0 or int(want[4]) != 0 or not max(e[0] for e in errs) <= K1_TOL:
            raise RuntimeError(f"K1 disagrees with its plain version on an HPD block, nb={nb}")

    # a bad pivot in each block column, a ragged one, and a NaN pivot: fail
    # exact, L held on all rows of the columns before the pivot, its inverse
    # on the leading block before it
    for nb, row, value in ((128, 0, -1e4), (128, 31, -1e4), (128, 32, -1e4), (128, 37, -1e4),
                           (128, 127, -1e4), (33, 32, -1e4), (128, 64, float("nan"))):
        br, bi = _hpd_block(torch, nb, 1, dev)
        br[row, row] = value
        got_b = pchol_block_planar(br, bi)
        want_b = pchol_block_plain(br, bi)
        torch.cuda.synchronize()
        fk, fp = int(got_b[4]), int(want_b[4])
        lead = [rel_err(g[:, :row], w[:, :row])[0] if row else 0.0
                for g, w in zip(got_b[:2], want_b[:2])]
        lead += [rel_err(g[:row, :row], w[:row, :row])[0] if row else 0.0
                 for g, w in zip(got_b[2:4], want_b[2:4])]
        log(f"K1 nb={nb} pivot {row} set to {value}: fail kernel={fk} plain={fp} "
            f"rel_err ld_r ld_i (columns < {row}), inv_r inv_i (leading {row} x {row}) "
            f"{[f'{e:.2e}' for e in lead]}")
        if fk != fp or fk != row + 1 or not max(lead) <= K1_TOL:
            raise RuntimeError(f"K1 fail contract differs from its plain version (pivot {row})")

    nb = 128
    dr, di = _hpd_block(torch, nb, 0, dev)
    if not all(torch.equal(x, y) for x, y in zip(pchol_block_planar(dr, di),
                                                 pchol_block_planar(dr, di))):
        raise RuntimeError("K1 is not reproducible from run to run")
    ms = device_ms(lambda: pchol_block_planar(dr, di), iters=50)
    plain_ms = device_ms(lambda: pchol_block_plain(dr, di), iters=3)
    zc = torch.complex(dr, di)

    def library():
        l, _ = torch.linalg.cholesky_ex(zc)
        eye = torch.eye(nb, dtype=zc.dtype, device=dev)
        return torch.linalg.solve_triangular(l, eye, upper=False)

    library_ms = device_ms(library, iters=50)
    # work the kernel must do for this block: factor + inverse, complex
    nbytes, flops = _k1_work(nb)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"K1 times at nb={nb}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"library (cholesky_ex + solve_triangular, complex64) {library_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    return {
        "name": "pchol_block_planar", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/pchol_block.cu",
        "replaces": "eigensolver_gpu_tpu/ops/pchol_pallas.py:118",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def _k1_work(nb):
    """(bytes, flops) one K1 call must move and do for an nb block:
    factor + inverse, complex; the input planes read once, the four output
    planes and fail written once."""
    flops = 0
    for j in range(nb):
        m = nb - 1 - j
        flops += 2 * m + 8 * m * (m + 1) // 2  # scale column, lower downdate
        flops += 2 * (j + 1) + 8 * m * (j + 1)  # inverse row, downdate
    return 4 * (2 + 4) * nb * nb + 4, flops


def check_k1_batched(torch, entry):
    """K1 on a batch of K1_BATCH blocks in one launch (the batched Cholesky's
    block step): each item bit-identical to the unbatched launch on it,
    within K1_TOL of the plain version, fail exact, one kernel a call
    (profiler); its time against the bound of the batch's work and the
    library's batched pair. Adds the readings to K1's entry under
    "batched"."""
    import numpy as np

    from eigensolver_gpu_torch.ops.pchol import pchol_block_plain, pchol_block_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    dev, batch, nb = "cuda", K1_BATCH, 128
    rng = np.random.default_rng(11)
    max_abs = 0.0
    for width, bad in ((nb, 37), (100, 64)):
        t = rng.standard_normal((batch, width, width)) + 1j * rng.standard_normal(
            (batch, width, width))
        a = t @ t.conj().transpose(0, 2, 1) + width * np.eye(width)
        a[5, bad, bad] = -1e4  # one bad pivot in one item
        # the leading rows of (batch, 2 width, width) panels: batch and row strides
        pan = np.concatenate([a, np.zeros_like(a)], 1)
        f = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
        dr, di = f(pan.real)[:, :width], f(pan.imag)[:, :width]
        pchol_block_planar.launches = 0
        got = pchol_block_planar(dr, di)
        want = pchol_block_plain(dr, di)
        torch.cuda.synchronize()
        if pchol_block_planar.launches != 1:
            raise RuntimeError("batched K1 took more than one launch")
        fails = got[4].cpu().tolist()
        if fails != want[4].cpu().tolist() or fails != [0] * 5 + [bad + 1] + [0] * (batch - 6):
            raise RuntimeError(f"batched K1 fail {fails}")
        same, worst = True, 0.0
        for k in range(batch):
            one = pchol_block_planar(dr[k], di[k])
            same &= all(bool(((x[k] == y) | (x[k].isnan() & y.isnan())).all())
                        for x, y in zip(got, one))
            c = bad if k == 5 else width
            held = [(x[k][:, :c], y[k][:, :c]) for x, y in zip(got[:2], want[:2])]
            held += [(x[k][:c, :c], y[k][:c, :c]) for x, y in zip(got[2:4], want[2:4])]
            for g, w in held:
                rel, err = rel_err(g, w)
                worst = max(worst, rel)
                max_abs = max(max_abs, err)
        log(f"K1 batched batch={batch} nb={width} (bad pivot in item 5 at row {bad}): "
            f"fail exact, one launch, every item bit-identical to its unbatched launch: "
            f"{same}, rel_err vs plain {worst:.2e}")
        if not same or not worst <= K1_TOL:
            raise RuntimeError(f"batched K1 disagrees (nb={width})")
    t = rng.standard_normal((batch, nb, nb)) + 1j * rng.standard_normal((batch, nb, nb))
    a = t @ t.conj().transpose(0, 2, 1) + nb * np.eye(nb)
    dr = torch.tensor(a.real, dtype=torch.float32, device=dev)
    di = torch.tensor(a.imag, dtype=torch.float32, device=dev)
    _, kernels = _kineto(torch, lambda: pchol_block_planar(dr, di), "pchol")
    if kernels != 1:
        raise RuntimeError(f"a batched K1 call ran {kernels} kernels (profiler), want 1")
    ms = device_ms(lambda: pchol_block_planar(dr, di), iters=20)
    plain_ms = device_ms(lambda: pchol_block_plain(dr, di), iters=2)
    zc = torch.complex(dr, di)
    eye = torch.eye(nb, dtype=zc.dtype, device=dev)

    def library():
        l, _ = torch.linalg.cholesky_ex(zc)
        return torch.linalg.solve_triangular(l, eye, upper=False)

    library_ms = device_ms(library, iters=20)
    nbytes, flops = _k1_work(nb)
    bound_ms, bound_by = bound(batch * nbytes, batch * flops)
    log(f"K1 batched times at batch={batch} nb={nb}: kernel {ms:.4f} ms ({ms / batch * 1e3:.2f} us "
        f"an item; one block {entry['ms']:.4f} ms), plain {plain_ms:.3f} ms, library "
        f"(batched cholesky_ex + solve_triangular, complex64) {library_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}); one kernel a call (profiler)")
    entry["batched"] = {"batch": batch, "nb": nb, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                        "max_abs_err": max_abs}


def _k2_work(mb, pe, nb):
    """Bytes and flops one panel needs. Each column's y = A v needs the v of
    the column before it, so every column reads the leading cj x cj block of
    both planes (8 cj^2 bytes). The first column reads it from device memory;
    a later one at least the part that the L2 cannot have kept since, past
    its L2_BYTES: none where the block fits (mb <= 2048), and at mb = 4096,
    whose block is 134 MB, 8 cj^2 - L2_BYTES. The raw columns are read once
    and the outputs written once. Flops: the matvecs and the compact-WY
    corrections."""
    nbytes = 8 * mb * nb + 4 * (6 * mb * nb + 4 * nb)
    flops = 0
    for s in range(nb):
        cj = pe - 1 - s
        # the leading block: all of it once, then what the L2 cannot hold
        nbytes += 8 * cj * cj if s == 0 else max(0, 8 * cj * cj - L2_BYTES)
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
            if pe == mb:  # the sums run in a fixed order: two calls, the same bits
                again = latrd_panel_planar(ar, ai, pe, nb=nb)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"K2 is not reproducible at mb={mb}{layout}")
    mb = 4096
    ar, ai = planes[mb]
    kernel_ms, launched = _kineto(torch, lambda: latrd_panel_planar(ar, ai, mb, nb=nb), "latrd_")
    if launched != 1:
        raise RuntimeError(f"one K2 call launched {launched} kernels (kineto), want 1")
    ms = device_ms(lambda: latrd_panel_planar(ar, ai, mb, nb=nb), iters=5)
    plain_ms = device_ms(lambda: latrd_panel_plain(ar, ai, mb, nb=nb), iters=2)
    bound_ms, bound_by = bound(*_k2_work(mb, mb, nb))
    log(f"K2 times at mb={mb} pe={mb}: kernel {ms:.3f} ms in 1 launch (kineto {kernel_ms:.3f} ms; "
        f"the launch sequence of 65 kernels: {K2_LAUNCH_SEQUENCE_MS} ms, PERF.md), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); no single library call "
        "computes a zlatrd panel (library_ms null)")
    # smaller contiguous blocks, whose two planes fit in the 50 MB L2
    for mbs in (2048, 1024):
        xr, xi = ar[:mbs, :mbs].contiguous(), ai[:mbs, :mbs].contiguous()
        small_ms = device_ms(lambda: latrd_panel_planar(xr, xi, mbs, nb=nb), iters=5)
        b_ms, b_by = bound(*_k2_work(mbs, mbs, nb))
        log(f"K2 times at mb={mbs} pe={mbs} (contiguous): kernel {small_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; the block fits in L2, read from device memory "
            "once a panel)")
    return {
        "name": "latrd_panel_planar", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/latrd_panel.cu",
        "replaces": "eigensolver_gpu_tpu/ops/latrd_pallas.py:300",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _herm_planes_on_card(torch, batch, n, seed):
    """(batch, n, n) fp32 planes of Hermitian matrices, drawn on the card
    from a seeded generator: the symmetric real and the antisymmetric
    imaginary part of (t + t^H) / 2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randn((2, batch, n, n), generator=g, device="cuda")
    return (t[0] + t[0].mT) / 2, (t[1] - t[1].mT) / 2


def check_k2_batched(torch, entry):
    """K2 on batches in one launch: K1_BATCH x (1024, 1024) planes at pe =
    1024 and 544 (the planar k-point batch's largest bucket; 32 blocks an
    item, so as many groups of 32 as are resident take the items in
    turns), and 2 x (4096, 4096) at pe = 4096 (128 blocks an item: one
    group, the items one after the other). Each item bit-identical to its
    unbatched launch, within K2_TOL of the batched plain version, one kernel
    a call (counter and profiler); times at batch 64, pe = 1024 against the
    bound of the batch's work and against one unbatched launch, and at
    batch 2, mb = 4096 against K2's unbatched time. Adds the readings to
    K2's entry under "batched"."""
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_plain, latrd_panel_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    nb = 32
    planes = {K1_BATCH: _herm_planes_on_card(torch, K1_BATCH, N_BATCHED, 22),
              2: _herm_planes_on_card(torch, 2, 4096, 23)}
    max_abs = 0.0
    for batch, mb, pe in ((K1_BATCH, N_BATCHED, N_BATCHED), (K1_BATCH, N_BATCHED, 544),
                          (2, 4096, 4096)):
        ar, ai = planes[batch]
        label = f"batch={batch} mb={mb} pe={pe}"
        latrd_panel_planar.launches = 0
        got = latrd_panel_planar(ar, ai, pe, nb=nb)
        launches = latrd_panel_planar.launches
        want = latrd_panel_plain(ar, ai, pe, nb=nb)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        max_abs = max(max_abs, max(e[1] for e in errs))
        del want
        same = _same_items(torch, got, lambda k: latrd_panel_planar(ar[k], ai[k], pe, nb=nb),
                           batch)
        _, kernels = _kineto(torch, lambda: latrd_panel_planar(ar, ai, pe, nb=nb), "latrd_")
        log(f"K2 batched {label}: one launch (counter {launches}, kineto {kernels}), every item "
            f"bit-identical to its unbatched launch: {same}, worst rel_err vs plain "
            f"{max(e[0] for e in errs):.1e}")
        if launches != 1 or kernels != 1 or not same or not max(e[0] for e in errs) <= K2_TOL:
            raise RuntimeError(f"batched K2 disagrees at {label}")
    batch, mb = K1_BATCH, N_BATCHED
    ar, ai = planes[batch]
    ms = device_ms(lambda: latrd_panel_planar(ar, ai, mb, nb=nb), iters=3)
    one_ms = device_ms(lambda: latrd_panel_planar(ar[0], ai[0], mb, nb=nb), iters=10)
    plain_ms = device_ms(lambda: latrd_panel_plain(ar, ai, mb, nb=nb), iters=1)
    nbytes, flops = _k2_work(mb, mb, nb)
    bound_ms, bound_by = bound(batch * nbytes, batch * flops)
    xr, xi = planes[2]
    two_ms = device_ms(lambda: latrd_panel_planar(xr, xi, 4096, nb=nb), iters=3)
    log(f"K2 batched times at batch={batch} mb=pe={mb}: kernel {ms:.3f} ms in 1 launch "
        f"({ms / batch * 1e3:.1f} us an item; one item alone {one_ms:.4f} ms, {batch} such "
        f"launches {batch * one_ms:.3f} ms), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); library_ms null (no single call computes a zlatrd panel); batch=2 "
        f"mb=pe=4096: {two_ms:.3f} ms (one item alone {entry['ms']:.3f} ms)")
    entry["batched"] = {"batch": batch, "shape": f"mb=pe={mb} nb={nb} fp32", "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "max_abs_err": max_abs}


def _mv_bound(n, planes, itemsize=4, batch=1):
    """The upper triangle with its diagonal, n (n + 1) / 2 elements a plane,
    read once, v read and y written once: the work, whatever tile the
    kernel uses (of each of ``batch`` problems)."""
    nbytes = itemsize * planes * (n * (n + 1) // 2 + 2 * n)
    flops = 2 * n * n * (1 if planes == 1 else 4)
    return bound(batch * nbytes, batch * flops)


_FLUSH_KERNELS = set()  # device record names of the flush


def _cold_ms(torch, fn, iters=20):
    """Mean device ms of the kernels of one call of ``fn`` with a cold L2:
    before each call a FLUSH_BYTES buffer is written and then read (so the
    50 MB L2 holds none of the operands and no dirty line of the buffer),
    and only the call's own kernels are summed, each by its duration in the
    profiler's device records. The buffer is freed on return, so it counts
    in no later peak-memory reading."""
    buf = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def flush():
        buf.fill_(1.0)
        return buf.sum()

    if not _FLUSH_KERNELS:
        _FLUSH_KERNELS.update(name for name, _ in _device_records(torch, flush))

    def run():
        for _ in range(iters):
            flush()
            fn()

    ns = [ns for name, ns in _device_records(torch, run) if name not in _FLUSH_KERNELS]
    return sum(ns) / 1e6 / iters


def _one_launch(torch, fn, key, what):
    """Fail unless one call of ``fn`` ran exactly one device operation, a
    kernel whose name holds ``key`` (profiler records; a profile that
    caught none of it is taken again, up to six calls)."""
    records = _device_records(torch, fn, (key,), cpu=True)
    if len(records) != 1 or key not in records[0][0]:
        raise RuntimeError(f"one {what} call ran {[r[0][:40] for r in records]} on the device "
                           f"(kineto), want one {key} launch")


def _same_bits(torch, fn, what):
    """Fail unless MV_REPEATS further calls of ``fn`` give the first call's bits."""
    first = fn()
    differ = sum(not all(torch.equal(x, y) for x, y in zip(fn(), first))
                 for _ in range(MV_REPEATS))
    log(f"{what}: {differ} of {MV_REPEATS} repeated calls give other bits than the first")
    if differ:
        raise RuntimeError(f"{what} is not reproducible from call to call")


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
        ("n=4096 fp64", a64, v64, None, MV_TOL64),
    ]
    # the solve's extents on the lda = 4096 view; rows that are not 16-byte
    # aligned (n = 999 contiguous) and n = 1
    cases += [(f"n=4096 extent={c}", a32, v32, c, MV_TOL) for c in MV_EXTENTS]
    cases += [(f"n={c} contiguous {name}", x[:c, :c].contiguous(), y[:c], None, tol)
              for c in (999, 1) for name, x, y, tol in (("fp32", a32, v32, MV_TOL),
                                                        ("fp64", a64, v64, MV_TOL64))]
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
    for name, a, v in (("fp32", a32, v32), ("fp64", a64, v64)):
        _same_bits(torch, lambda: (symv(a, v),), f"K4 n=4096 {name}")
        _one_launch(torch, lambda: symv(a, v), "symv_kernel", f"K4 n=4096 {name}")
    ms = device_ms(lambda: symv(a32, v32), iters=100)
    cold = _cold_ms(torch, lambda: symv(a32, v32))
    plain_ms = device_ms(lambda: symv_plain(a32, v32), iters=2)
    with true_fp32():
        library_ms = device_ms(lambda: torch.mv(a32, v32), iters=100)
        library_cold = _cold_ms(torch, lambda: torch.mv(a32, v32))
    bound_ms, bound_by = _mv_bound(4096, 1)
    log(f"K4 times at n=4096 fp32: kernel {ms:.4f} ms warm, {cold:.4f} cold ({bound_ms / cold:.0%} "
        f"of the bound), plain {plain_ms:.3f} ms, library (torch.mv, full matrix) "
        f"{library_ms:.4f} warm, {library_cold:.4f} cold, bound {bound_ms:.4f} ms ({bound_by})")
    b64, _ = _mv_bound(4096, 1, itemsize=8)
    warm64 = device_ms(lambda: symv(a64, v64), iters=100)
    cold64 = _cold_ms(torch, lambda: symv(a64, v64))
    log(f"K4 times at n=4096 fp64: kernel {warm64:.4f} ms warm, {cold64:.4f} cold "
        f"({b64 / cold64:.0%} of the bound), bound {b64:.4f} ms (bytes)")
    for c in MV_EXTENTS:  # the solve's extents, torch.mv on the same c x c view
        warm_c = device_ms(lambda: symv(a32, v32, extent=c), iters=100)
        cold_c = _cold_ms(torch, lambda: symv(a32, v32, extent=c))
        with true_fp32():
            mv_warm = device_ms(lambda: torch.mv(a32[:c, :c], v32[:c]), iters=100)
            mv_cold = _cold_ms(torch, lambda: torch.mv(a32[:c, :c], v32[:c]))
        b_c, _ = _mv_bound(c, 1)
        log(f"K4 times at extent={c} of the lda=4096 view fp32: kernel {warm_c:.4f} ms warm, "
            f"{cold_c:.4f} cold ({b_c / cold_c:.0%} of the bound), torch.mv on the view "
            f"{mv_warm:.4f} warm, {mv_cold:.4f} cold, bound {b_c:.5f} ms")
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
    cases += [(f"n=4096 extent={c}", ar, ai, 4096, c) for c in (2047, 4095)]
    cases += [(f"n={c} contiguous", ar[:c, :c].contiguous(), ai[:c, :c].contiguous(), c, None)
              for c in (999, 1)]
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
    _same_bits(torch, lambda: hemv_planar(ar, ai, vr, vi), "K3 n=4096")
    _one_launch(torch, lambda: hemv_planar(ar, ai, vr, vi), "hemv_planar_kernel", "K3 n=4096")
    ms = device_ms(lambda: hemv_planar(ar, ai, vr, vi), iters=100)
    plain_ms = device_ms(lambda: hemv_planar_plain(ar, ai, vr, vi), iters=2)
    ac, vc = torch.complex(ar, ai), torch.complex(vr, vi)
    with true_fp32():
        library_ms = device_ms(lambda: torch.mv(ac, vc), iters=100)
    bound_ms, bound_by = _mv_bound(4096, 2)
    log(f"K3 times at n=4096 fp32: kernel {ms:.4f} ms warm, plain {plain_ms:.3f} ms, "
        f"library (torch.mv, complex64, full matrix) {library_ms:.4f} ms warm, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    for c in (2047, 4095, 4096):  # cold and warm, torch.mv on the same c x c view
        warm_c = device_ms(lambda: hemv_planar(ar, ai, vr, vi, extent=c), iters=100)
        cold_c = _cold_ms(torch, lambda: hemv_planar(ar, ai, vr, vi, extent=c))
        with true_fp32():
            mv_warm = device_ms(lambda: torch.mv(ac[:c, :c], vc[:c]), iters=100)
            mv_cold = _cold_ms(torch, lambda: torch.mv(ac[:c, :c], vc[:c]))
        b_c, _ = _mv_bound(c, 2)
        log(f"K3 times at extent={c} of the lda=4096 view: kernel {warm_c:.4f} ms warm, "
            f"{cold_c:.4f} cold ({b_c / cold_c:.0%} of the bound), torch.mv complex64 on the "
            f"view {mv_warm:.4f} warm, {mv_cold:.4f} cold, bound {b_c:.5f} ms")

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


def check_k4_batched(torch, entry):
    """K4 on K1_BATCH x n = 1024 symmetric matrices (the real k-point
    batch's largest bucket, lda = 1024) in one launch, fp32 and fp64, full
    and at extent 999: each item bit-identical to its unbatched launch,
    within MV_TOL (MV_TOL64) of the batched plain version, one kernel a
    call (counter and profiler); times at fp32, full, warm and with a cold
    L2, against the bound of the batch's work and the batched torch.matmul.
    Adds the readings to K4's entry under "batched"."""
    from eigensolver_gpu_torch.ops.symv import symv, symv_plain
    from eigensolver_gpu_torch.utils.precision import true_fp32
    from eigensolver_gpu_torch.utils.timer import device_ms

    batch, n = K1_BATCH, N_BATCHED
    g = torch.Generator(device="cuda").manual_seed(24)
    t = torch.randn((batch, n, n), generator=g, device="cuda", dtype=torch.float64)
    a64 = (t + t.mT) / 2
    del t
    v64 = torch.randn((batch, n), generator=g, device="cuda", dtype=torch.float64)
    a32, v32 = a64.float(), v64.float()
    max_abs = 0.0
    for name, a, v, tol in (("fp32", a32, v32, MV_TOL), ("fp64", a64, v64, MV_TOL64)):
        for extent in (None, 999):
            c = n if extent is None else extent
            label = f"batch={batch} n={n} extent={extent} {name}"
            symv.launches = 0
            got = symv(a, v, extent=extent)
            launches = symv.launches
            want = symv_plain(a[:, :c, :c], v[:, :c])
            torch.cuda.synchronize()
            rel, err = rel_err(got, want)
            if tol == MV_TOL:
                max_abs = max(max_abs, err)
            same = _same_items(torch, (got,), lambda k: (symv(a[k], v[k], extent=extent),),
                               batch)
            _, kernels = _kineto(torch, lambda: symv(a, v, extent=extent), "symv_kernel")
            log(f"K4 batched {label}: one launch (counter {launches}, kineto {kernels}), every "
                f"item bit-identical to its unbatched launch: {same}, rel_err vs plain {rel:.2e}")
            if launches != 1 or kernels != 1 or not same or got.shape != (batch, c) \
                    or not rel <= tol:
                raise RuntimeError(f"batched K4 disagrees at {label}")
    ms = device_ms(lambda: symv(a32, v32), iters=20)
    cold = _cold_ms(torch, lambda: symv(a32, v32), iters=5)
    one_ms = device_ms(lambda: symv(a32[0], v32[0]), iters=100)
    ms64 = device_ms(lambda: symv(a64, v64), iters=20)
    plain_ms = device_ms(lambda: symv_plain(a32, v32), iters=1)
    with true_fp32():
        library_ms = device_ms(lambda: torch.matmul(a32, v32[..., None]), iters=20)
    bound_ms, bound_by = _mv_bound(n, 1, batch=batch)
    b64, _ = _mv_bound(n, 1, itemsize=8, batch=batch)
    log(f"K4 batched times at batch={batch} n={n} fp32: kernel {ms:.4f} ms warm, {cold:.4f} cold "
        f"({bound_ms / cold:.0%} of the bound; one item alone {one_ms:.4f} ms warm), plain "
        f"{plain_ms:.3f} ms, library (torch.matmul (B, n, n) x (B, n, 1), full matrices) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); fp64 {ms64:.4f} ms warm "
        f"against its bound {b64:.4f} ms")
    entry["batched"] = {"batch": batch, "shape": f"n={n} fp32", "ms": ms, "cold_ms": cold,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "max_abs_err": max_abs}


def check_k3_batched(torch, entry):
    """K3 on K1_BATCH x n = 1024 planar Hermitian matrices in one launch,
    full and at extent 999: each item bit-identical to its unbatched launch,
    within MV_TOL of the batched plain version, one kernel a call (counter
    and profiler); times against the bound of the batch's work and the
    batched complex64 torch.matmul; then one full panel of the planar column
    loop with use_pallas on the batch (32 launches, one a column for the
    whole batch) against the loop without it. Adds the readings to K3's
    entry under "batched"."""
    from eigensolver_gpu_torch.ops.symv import hemv_planar, hemv_planar_plain
    from eigensolver_gpu_torch.ops.sytrd_planar import _panel_columns_planar
    from eigensolver_gpu_torch.utils.precision import true_fp32
    from eigensolver_gpu_torch.utils.timer import device_ms

    batch, n = K1_BATCH, N_BATCHED
    ar, ai = _herm_planes_on_card(torch, batch, n, 33)
    g = torch.Generator(device="cuda").manual_seed(34)
    vr, vi = torch.randn((2, batch, n), generator=g, device="cuda")
    max_abs = 0.0
    for extent in (None, 999):
        c = n if extent is None else extent
        label = f"batch={batch} n={n} extent={extent}"
        hemv_planar.launches = 0
        got = hemv_planar(ar, ai, vr, vi, extent=extent)
        launches = hemv_planar.launches
        want = hemv_planar_plain(ar[:, :c, :c], ai[:, :c, :c], vr[:, :c], vi[:, :c])
        torch.cuda.synchronize()
        scale = max(float(w.abs().max()) for w in want)
        err = max(float((x - w).abs().max()) for x, w in zip(got, want))
        max_abs = max(max_abs, err)
        same = _same_items(torch, got,
                           lambda k: hemv_planar(ar[k], ai[k], vr[k], vi[k], extent=extent), batch)
        _, kernels = _kineto(torch, lambda: hemv_planar(ar, ai, vr, vi, extent=extent),
                             "hemv_planar_kernel")
        log(f"K3 batched {label}: one launch (counter {launches}, kineto {kernels}), every item "
            f"bit-identical to its unbatched launch: {same}, rel_err vs plain {err / scale:.2e}")
        if launches != 1 or kernels != 1 or not same or not err <= MV_TOL * scale:
            raise RuntimeError(f"batched K3 disagrees at {label}")
    ms = device_ms(lambda: hemv_planar(ar, ai, vr, vi), iters=20)
    one_ms = device_ms(lambda: hemv_planar(ar[0], ai[0], vr[0], vi[0]), iters=100)
    plain_ms = device_ms(lambda: hemv_planar_plain(ar, ai, vr, vi), iters=1)
    ac, vc = torch.complex(ar, ai), torch.complex(vr, vi)[..., None]
    with true_fp32():
        library_ms = device_ms(lambda: torch.matmul(ac, vc), iters=20)
    del ac, vc
    bound_ms, bound_by = _mv_bound(n, 2, batch=batch)
    log(f"K3 batched times at batch={batch} n={n}: kernel {ms:.4f} ms warm (one item alone "
        f"{one_ms:.4f} ms), plain {plain_ms:.3f} ms, library (torch.matmul complex64 (B, n, n) x "
        f"(B, n, 1)) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    # the path that launches K3, on the batch: one full panel of the column loop
    nb, outs = 32, {}
    for use_pallas in (False, True):
        pr, pi = ar.clone(), ai.clone()
        d, e, taur, taui = (torch.zeros((batch, n), device="cuda") for _ in range(4))
        hemv_planar.launches = 0
        with true_fp32():
            panels = _panel_columns_planar(pr, pi, d, e, taur, taui, n, nb,
                                           use_pallas=use_pallas)
        torch.cuda.synchronize()
        outs[use_pallas] = (*panels, pr[..., n - nb:], pi[..., n - nb:], d, e, taur, taui)
        launches = hemv_planar.launches
        if launches != (nb if use_pallas else 0):
            raise RuntimeError(f"batched K3 launches in one panel: {launches} "
                               f"(use_pallas={use_pallas})")
    names = ["vr", "vi", "wr", "wi", "colr", "coli", "d", "e", "taur", "taui"]
    errs = [rel_err(x, w)[0] for x, w in zip(outs[True], outs[False])]
    log(f"K3 batched panel batch={batch} mb=pe={n}: launches {launches}, rel_err kernel path vs "
        "matmul path " + " ".join(f"{nm}={x:.1e}" for nm, x in zip(names, errs)))
    if not max(errs) <= K2_TOL:
        raise RuntimeError("the batched planar column loop with K3 disagrees with the matmul path")
    entry["batched"] = {"batch": batch, "shape": f"n={n} fp32", "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                        "max_abs_err": max_abs, "launches": launches}


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


def _device_records(torch, fn, keys=(), tries=4, cpu=False):
    """The (name, ns) of every kernel and copy the device ran during one call
    of ``fn``, from the raw kineto records. A profile that caught no device
    record at all, or none of a kernel named by ``keys`` (both seen on the
    card now and then; the kernels' own launch counters are checked apart)
    is no reading: it is taken again, a second later, up to ``tries`` calls,
    each retry logged; then ProfilerDropped is raised, and main runs the
    group again in a new process.

    On the card a CUDA-only profile has lost the records of the kernels
    launched first in its session (a 40 ms chase missing, the copies and
    kernels after it caught), three to six sessions running; so fn starts
    a tenth of a second into the session, and ``cpu`` adds the CPU activity
    (no such loss seen with it), which the calls of one wrapper take and
    the profiled solves, with their 10^5 host ops, do not."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for attempt in range(tries):
        if attempt:
            log(f"  profile {attempt} of {tries} caught no record of {keys or 'any kernel'}; "
                "taken again")
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(0.1)
            fn()
            torch.cuda.synchronize()
        records = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        if records and all(any(k in name for name, _ in records) for k in keys):
            return records
        log(f"  (that profile held {len(records)} device records)")
    raise ProfilerDropped(f"the profiler caught no device record of {keys or 'any kernel'} in "
                          f"{tries} profiled calls")


def _kineto(torch, fn, key):
    """(device ms, launches) of the kernels whose name holds ``key`` during
    one call of ``fn``, from the raw kineto records."""
    ms, count = 0.0, 0
    for name, ns in _device_records(torch, fn, (key,), cpu=True):
        if key in name:
            ms += ns / 1e6
            count += 1
    return ms, count


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
    trivial[: 64 + 15, 15] = 0.0  # last column zero above its pivot, one block
    # a trivial column whose zero tail crosses the row slabs of a 5-block launch
    rb_t = 1000
    trivial_x = big32[:1100, :16].clone()
    trivial_x[: rb_t + 15, 15] = 0.0
    sl = lambda x, rows, c0, c1: x[:rows, c0:c1]
    # every panel sbrd factors at n = 4096, band 32: column slices of the
    # 4096^2 matrix, row stride 4096
    cases = []  # (label, panel, rows_below, tolerance)
    for p in range(4096 // BAND - 1):
        pend = 4096 - p * BAND
        mrows = pend - BAND
        cases.append((f"sbrd panel {p} ({pend}, {BAND}) rb={mrows - BAND}",
                      sl(big32, pend, mrows, pend), mrows - BAND, K5_TOL))
    cases += [
        ("(4096, 32) rb=4032", big32[:, :32].contiguous(), 4096 - 64, K5_TOL),
        ("(4096, 32) rb=4032, column slice of 4096^2", big32[:, 4032:4064], 4096 - 64, K5_TOL),
        ("(2048, 32) rb=1984, slice of a leading block", big32[:2048, 2016:2048], 1984, K5_TOL),
        ("(1000, 32) rb=936", big32[:1000, 100:132], 936, K5_TOL),
        ("(1000, 24) rb=500", big32[:1000, 7:31], 500, K5_TOL),
        ("(20, 16) rb=2, fewer rows than a slab", sl(big32, 20, 3, 19), 2, K5_TOL),
        ("(300, 1) rb=250", sl(big32, 300, 5, 6), 250, K5_TOL),
        ("(700, 64) rb=0", sl(big32, 700, 0, 64), 0, K5_TOL),
        ("(128, 16) rb=64 trivial column", trivial, 64, K5_TOL),
        ("(1100, 16) rb=1000 trivial column across slabs", trivial_x, rb_t, K5_TOL),
        ("(1024, 32) rb=960 fp64", big[:1024, 64:96], 960, K5_TOL64),
        ("(4096, 64) rb=3968 fp64", sl(big, 4096, 100, 164), 4096 - 128, K5_TOL64),
    ]
    names = ["r_panel", "v", "tau", "t"]
    max_abs, worst = 0.0, (0.0, "")
    for label, p, rb, tol in cases:
        b = p.shape[1]
        got = ql_panel(p, rb)
        want = ql_panel_plain(p, rb)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if tol == K5_TOL:
            max_abs = max(max_abs, max(e[1] for e in errs))
        worst = max(worst, (max(e[0] for e in errs), label))
        if not label.startswith("sbrd") or label.startswith("sbrd panel 0 "):
            log(f"K5 {label}: rel_err " + " ".join(f"{n}={e[0]:.1e}" for n, e in zip(names, errs)))
        if any(g.shape != w.shape for g, w in zip(got, want)) or not max(e[0] for e in errs) <= tol:
            raise RuntimeError(f"K5 disagrees with its plain version at {label}")
        if "trivial" in label:
            if float(got[2][b - 1]) != 0.0 or float(got[1][:, b - 1].abs().max()) != 0.0 \
                    or not torch.equal(got[0][:, b - 1], p[:, b - 1]):
                raise RuntimeError(f"K5 trivial column at {label}: tau, v or the column break "
                                   "the contract")
            log(f"K5 {label}: tau = 0, v = 0 and the column kept, exactly")
        if label.startswith("sbrd panel 0 ") or "fp64" in label or "trivial" in label:
            if not all(torch.equal(x, y) for x, y in zip(got, ql_panel(p, rb))):
                raise RuntimeError(f"K5 is not reproducible from run to run at {label}")
    log(f"K5: {len(cases)} shapes held, the 127 sbrd panels among them; worst rel_err "
        f"{worst[0]:.1e} at {worst[1]}; two calls bit-identical on sbrd panel 0 (16 blocks), "
        "the trivial and the fp64 shapes")
    _, p, rb, _ = cases[4096 // BAND]  # the column slice
    ms = device_ms(lambda: ql_panel(p, rb), iters=20)
    plain_ms = device_ms(lambda: ql_panel_plain(p, rb), iters=2)
    bound_ms, bound_by = bound(*_k5_work(4096, 32, rb, 4))
    log(f"K5 times at (4096, 32) rb={rb} fp32: kernel {ms:.4f} ms (the one-block design before "
        f"the cluster: {K5_ONE_BLOCK_MS} ms, PERF.md), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}); no single library call returns a QL panel with its T "
        "(library_ms null)")
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
    from eigensolver_gpu_torch.ops.sb2st import apply_q2, band_to_dense, bulge_chase, chase_dims
    from eigensolver_gpu_torch.utils.timer import device_ms

    names = ["d", "e", "vt", "taut"]
    record = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # n = 2400, b = 6 has 134 slots: more than the SMs, so a block of the
    # persistent kernel owns several. There ("ill") the reflectors of the
    # narrow band are ill-conditioned functions of it: a perturbation of the
    # band in its last bits moves the plain chase's own reflectors by about
    # 1e-6 in fp64 (whole arrays) and by 1e-2 and more in fp32 (already on
    # its first sweeps, as measured on the card). So there fp64 holds d and e whole
    # and the reflectors on the first K7_HEAD sweeps, and fp32 d and |e| on
    # the first K7_HEAD sweeps, with the spectrum and the similarity for the
    # whole output. The plain chase costs about a millisecond a timestep: at
    # n = 4096 it runs once, in the main path's type; the fp64 instance is
    # held there through spectrum and similarity, as K8's; so is the fp32
    # instance at n = 2400, whose slots outnumber the blocks in fp64 at that
    # shape and in fp32 in the batched check (held against the plain chase)
    for n, b, dtype, ill, with_plain in (
            (100, 6, torch.float32, False, True), (100, 6, torch.float64, False, True),
            (2400, 6, torch.float32, True, False), (2400, 6, torch.float64, True, True),
            (4096, BAND, torch.float32, False, True),
            (4096, BAND, torch.float64, False, False)):
        f32 = dtype == torch.float32
        label = f"n={n} b={b} {'fp32' if f32 else 'fp64'}"
        slots = chase_dims(n, b)[0]
        if slots > sms:
            label += f" ({slots} slots on {sms} blocks)"
        band, sci = _random_band(torch, n, b, 7, dtype)
        got = bulge_chase_kernel(band, b)
        if not all(torch.equal(x, y) for x, y in zip(got, bulge_chase_kernel(band, b))):
            raise RuntimeError(f"K7 is not reproducible from run to run at {label}")
        errs, msg = [], ""
        if with_plain:
            want, plain_ms = _timed_once(torch, lambda: bulge_chase(band, b))
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
            h = min(K7_HEAD, n - 1)
            if f32:
                pairs = [(got[0][:h], want[0][:h]), (got[1][:h].abs(), want[1][:h].abs())]
                if not ill:
                    pairs += [((got[2] * act)[: 3 * h].abs(), (want[2] * act)[: 3 * h].abs()),
                              (got[3][: 3 * h], want[3][: 3 * h])]
            elif ill:
                pairs = [(got[0], want[0]), (got[1], want[1]),
                         ((got[2] * act)[: 3 * h], (want[2] * act)[: 3 * h]),
                         (got[3][: 3 * h], want[3][: 3 * h])]
            else:
                pairs = [(got[0], want[0]), (got[1], want[1]), (got[2] * act, want[2] * act),
                         (got[3], want[3])]
            errs = [rel_err(g, w) for g, w in pairs]
            held = ("d, |e|" + ("" if ill else ", |vt|, taut") + f" on the first {h} sweeps"
                    if f32 else f"d, e whole, vt, taut on the first {h} sweeps" if ill
                    else "whole arrays")
            msg = (f" rel_err vs plain ({held}) "
                   + " ".join(f"{k}={x[0]:.1e}" for k, x in zip(names, errs))
                   + ("; whole arrays, signed: " + " ".join(
                       f"{k}={x:.1e}" for k, x in zip(names, full)) if f32 or ill else "")
                   + ";")
        w_band = scipy.linalg.eigvals_banded(sci, lower=True)
        outs = (got, want) if with_plain else (got,)
        spec, sim = [], []
        for out in outs:
            d, e = out[0].double().cpu().numpy(), out[1].double().cpu().numpy()
            w = scipy.linalg.eigvalsh_tridiagonal(d, e)
            spec.append(float(np.abs(w - w_band).max() / np.abs(w_band).max()))
        dense = band_to_dense(band, b)
        for d, e, vt, taut in outs:
            q2 = apply_q2(vt, taut, torch.eye(n, dtype=dtype, device="cuda"), n, b, g=b)
            tri = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
            sim.append(rel_err(q2 @ tri @ q2.T, dense)[0])
        plain = lambda x: f", plain {x[1]:.1e}" if with_plain else ""
        log(f"K7 {label}:{msg} spectrum vs the band matrix: kernel {spec[0]:.1e}{plain(spec)}"
            f"; Q2 T Q2^T vs the band matrix: kernel {sim[0]:.1e}{plain(sim)}")
        tol, spec_tol = (K7_TOL, K7_SPEC_TOL) if f32 else (K7_TOL64, K7_SPEC_TOL64)
        if not spec[0] <= spec_tol or not sim[0] <= spec_tol \
                or (errs and not max(x[0] for x in errs) <= tol):
            raise RuntimeError(f"K7 disagrees with its plain version at {label}")
        if n == 4096:
            ms = device_ms(lambda: bulge_chase_kernel(band, b), iters=3)
            _, launched = _kineto(torch, lambda: bulge_chase_kernel(band, b), "chase_kernel")
            if launched != 1:
                raise RuntimeError(f"one K7 call launched {launched} kernels (kineto), want 1")
            nbytes, flops, windows = _k7_work(n, b, 4 if f32 else 8)
            bound_ms, bound_by = bound(nbytes, flops)
            log(f"K7 times at {label}: kernel {ms:.3f} ms in 1 launch (kineto)"
                + (f" (the launch sequence before the persistent kernel: "
                   f"{K7_LAUNCH_SEQUENCE_MS} ms, PERF.md)" if f32 else "")
                + (f", plain {plain_ms:.1f} ms" if with_plain else "")
                + f", bound {bound_ms:.4f} ms ({bound_by}; {windows} "
                "windows); no single library call chases a band to tridiagonal (library_ms null)")
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
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, window_store
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
    qs_ms = device_ms(lambda: window_store(vt, taut, n, b, g), iters=3)
    kernel_ms, launched = _kineto(torch, lambda: apply_q2_kernel(vt, taut, y_all, n, b, g=g),
                                  "replay_kernel")
    if launched != 1:
        raise RuntimeError(f"one K9 call launched {launched} kernels (kineto), want 1")
    store, _ = window_store(vt, taut, n, b, g)
    store_mb = store.numel() * store.element_size() / 1e6
    del store
    plain_ms = device_ms(lambda: apply_q2(vt, taut, y_all, n, b, g=g), iters=2)
    ms512 = device_ms(lambda: apply_q2_kernel(vt, taut, y_all[:, :512], n, b, g=g), iters=3)
    nbytes, flops, windows = _k9_work(n, 4096, b, g, 4)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"K9 times at n={n} m=4096 fp32: wrapper {ms:.3f} ms (one launch a wave with every slot "
        f"formed: {K9_ONE_LAUNCH_A_WAVE_MS} ms, PERF.md), of which the window pass window_store "
        f"{qs_ms:.3f} ms (outside the kernel; window store {store_mb:.1f} MB) and the kernel "
        f"{kernel_ms:.3f} ms in 1 launch (kineto); at m=512 {ms512:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {windows} windows); no single "
        "library call replays wave-ordered windows (library_ms null)")
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
    # trivial (zero tail, real pivot) and phase-only (zero tail, complex
    # pivot) columns whose tails cross the row slabs of a 4-block launch
    rb_t = 1000
    tr_r, tr_i = r32[:1100, :16].clone(), i32[:1100, :16].clone()
    tr_r[: rb_t + 15, 15] = 0.0
    tr_i[: rb_t + 16, 15] = 0.0
    tr_r[: rb_t + 14, 14] = 0.0
    tr_i[: rb_t + 14, 14] = 0.0
    sl = lambda x, rows, c0, c1: x[:rows, c0:c1]
    # every panel psbrd factors at n = 4096, band 32: column slices of the
    # 4096^2 planes, row stride 4096
    cases = []  # (label, real plane, imaginary plane, rows_below, tolerance)
    for p in range(4096 // BAND - 1):
        pend = 4096 - p * BAND
        mrows = pend - BAND
        cases.append((f"psbrd panel {p} ({pend}, {BAND}) rb={mrows - BAND}",
                      sl(r32, pend, mrows, pend), sl(i32, pend, mrows, pend), mrows - BAND, K6_TOL))
    cases += [
        ("(4096, 32) rb=4032 contiguous", r32[:, :32].contiguous(), i32[:, :32].contiguous(), 4032,
         K6_TOL),
        ("(1000, 24) rb=500", sl(r32, 1000, 7, 31), sl(i32, 1000, 7, 31), 500, K6_TOL),
        ("(300, 1) rb=0", sl(r32, 300, 5, 6), sl(i32, 300, 5, 6), 0, K6_TOL),
        ("(700, 24) rb=0", sl(r32, 700, 40, 64), sl(i32, 700, 40, 64), 0, K6_TOL),
        ("(700, 64) rb=0", sl(r32, 700, 0, 64), sl(i32, 700, 0, 64), 0, K6_TOL),
        ("(20, 16) rb=2, fewer rows than a slab", sl(r32, 20, 3, 19), sl(i32, 20, 3, 19), 2,
         K6_TOL),
        ("(1100, 16) rb=1000 trivial and phase-only columns across slabs", tr_r, tr_i, rb_t,
         K6_TOL),
        ("(1024, 32) rb=960 fp64", sl(big_r, 1024, 64, 96), sl(big_i, 1024, 64, 96), 960, K6_TOL64),
        ("(700, 64) rb=0 fp64", sl(big_r, 700, 0, 64), sl(big_i, 700, 0, 64), 0, K6_TOL64),
        ("(4096, 64) rb=3968 fp64, slabs in global memory", sl(big_r, 4096, 100, 164),
         sl(big_i, 4096, 100, 164), 4096 - 128, K6_TOL64),
    ]
    names = ["pf_r", "pf_i", "v_r", "v_i", "tau_r", "tau_i", "t_r", "t_i"]
    max_abs, worst = 0.0, (0.0, "")
    for label, pr, pi, rb, tol in cases:
        b = pr.shape[1]
        got = ql_panel_planar(pr, pi, rb)
        want = ql_panel_planar_plain(pr, pi, rb)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if tol == K6_TOL:
            max_abs = max(max_abs, max(e[1] for e in errs))
        worst = max(worst, (max(e[0] for e in errs), label))
        if not label.startswith("psbrd") or label.startswith("psbrd panel 0 "):
            log(f"K6 {label}: rel_err " + " ".join(f"{n}={e[0]:.1e}" for n, e in zip(names, errs)))
        if any(g.shape != w.shape for g, w in zip(got, want)) or not max(e[0] for e in errs) <= tol:
            raise RuntimeError(f"K6 disagrees with its plain version at {label}")
        if any(float(got[1][: rb + j + 1, j].abs().max()) != 0.0 for j in range(b)):
            raise RuntimeError(f"K6 left an imaginary part on or above a pivot at {label}")
        if "trivial" in label:
            if float(got[4][b - 1]) != 0.0 or float(got[5][b - 1]) != 0.0 \
                    or float(got[2][:, b - 1].abs().max()) != 0.0 \
                    or not torch.equal(got[0][:, b - 1], pr[:, b - 1]):
                raise RuntimeError("K6 trivial column: tau, v or the column break the contract")
            if float(got[5][b - 2]) == 0.0 or float(got[2][rb + b - 2, b - 2]) != 1.0:
                raise RuntimeError("K6 phase-only column: a complex pivot must give a reflector")
        if label.startswith("psbrd panel 0 ") or "fp64" in label or "trivial" in label:
            if not all(torch.equal(x, y) for x, y in zip(got, ql_panel_planar(pr, pi, rb))):
                raise RuntimeError(f"K6 is not reproducible from run to run at {label}")
    log(f"K6: {len(cases)} shapes held, the 127 psbrd panels among them; worst rel_err "
        f"{worst[0]:.1e} at {worst[1]}")
    _, pr, pi, rb, _ = cases[0]
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
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel, chase_planar_blocks
    from eigensolver_gpu_torch.ops.sb2st import chase_dims
    from eigensolver_gpu_torch.ops.sb2st_planar import bulge_chase_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    flat = lambda o: [o[0], o[1][0], o[1][1], o[2][0], o[2][1], o[3][0], o[3][1]]
    record = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the plain chase costs about a millisecond a timestep: it runs at
    # n = 4096 once, in the main path's type; the fp64 instance is held at
    # N_K8_HELD and checked through spectrum and similarity at n = 4096, as
    # are the instances at n = 2400 and n = 2048, b = 4 (their slots
    # outnumber the blocks, as the pairs do in the fp32 batched check, which
    # is held against the plain chase). At
    # n = 2400, b = 6 (134 slots) and n = 2048, b = 4 (171) the slots
    # outnumber the SMs; where they outnumber the blocks that fit on the
    # card at once too (logged), a block of the persistent kernel owns several.
    for n, b, dtype, with_plain in (
            (100, 6, torch.float32, True), (100, 6, torch.float64, True),
            (N_K8_HELD, BAND, torch.float64, True),
            (2400, 6, torch.float32, False), (2400, 6, torch.float64, False),
            (2048, 4, torch.float64, False), (4096, BAND, torch.float64, False),
            (4096, BAND, torch.float32, True)):
        f32 = dtype == torch.float32
        slots = chase_dims(n, b)[0]
        label = f"n={n} b={b} {'fp32' if f32 else 'fp64'}"
        if slots > sms:
            label += f" ({slots} slots on {chase_planar_blocks(b, slots, dtype)} blocks, {sms} SMs)"
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
                errs = _k8_moduli(torch, got, want)
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
                + (f" (the launch sequence before the persistent kernel: "
                   f"{K8_LAUNCH_SEQUENCE_MS} ms, PERF.md)" if f32 else "")
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
    from eigensolver_gpu_torch.ops.replay import (
        apply_q2_planar_kernel,
        window_store_planar,
        window_table,
    )
    from eigensolver_gpu_torch.ops.sb2st_planar import apply_q2_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(10)
    max_abs = 0.0
    n, b, g = 4096, BAND, REPLAY_G
    table = window_table(n, b, g)
    per_wave = np.diff(table["wave_ptr"])
    log(f"K10 n={n} b={b} g={g}: {len(table['row0'])} valid windows of {table['valid'].size} "
        f"slots in {len(per_wave)} waves; the first and last waves hold {per_wave[0]} and "
        f"{per_wave[-1]}")
    band_r, band_i, _ = _random_hband(torch, n, b, 10, torch.float32)
    _, _, vt, taut = bulge_chase_planar_kernel(band_r, band_i, b)
    y_all = torch.tensor(rng.standard_normal((2, n, 4096)), dtype=torch.float32, device="cuda")
    for m in (1, 100, 4096):
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
    # fp64 instances at the pure-fp64 path's group size g = b, odd sizes and
    # the reference phase's n = 1024
    for n64, b64, m64 in ((1000, 24, 70), (N_REF, BAND, IU_REF)):
        r64, i64, _ = _random_hband(torch, n64, b64, 11, torch.float64)
        _, _, vt64, taut64 = bulge_chase_planar_kernel(r64, i64, b64)
        y64 = tuple(torch.tensor(rng.standard_normal((n64, m64)), device="cuda") for _ in range(2))
        rel64 = max(rel_err(x, w)[0] for x, w in zip(
            apply_q2_planar_kernel(vt64, taut64, y64, n64, b64, g=b64),
            apply_q2_planar(vt64, taut64, y64, n64, b64, g=b64)))
        log(f"K10 n={n64} b={b64} g={b64} m={m64} fp64: rel_err vs plain {rel64:.2e}")
        if not rel64 <= K10_TOL64:
            raise RuntimeError("K10 (fp64) disagrees with its plain version")

    # the main path replays all n columns (the mixed solve refines from the
    # full fp32 basis): time m = 4096
    y = (y_all[0], y_all[1])
    ms = device_ms(lambda: apply_q2_planar_kernel(vt, taut, y, n, b, g=g), iters=3)
    qs_ms = device_ms(lambda: window_store_planar(vt, taut, n, b, g), iters=3)
    kernel_ms, launched = _kineto(torch, lambda: apply_q2_planar_kernel(vt, taut, y, n, b, g=g),
                                  "replay_planar_kernel")
    if launched != 1:
        raise RuntimeError(f"one K10 call launched {launched} kernels (kineto), want 1")
    store, _ = window_store_planar(vt, taut, n, b, g)
    store_mb = store.numel() * store.element_size() / 1e6
    del store
    plain_ms = device_ms(lambda: apply_q2_planar(vt, taut, y, n, b, g=g), iters=2)
    nbytes, flops, windows = _k9_work(n, 4096, b, g, 4)
    bound_ms, bound_by = bound(2 * nbytes, 4 * flops)  # two planes, complex products
    log(f"K10 times at n={n} m=4096 fp32: wrapper {ms:.3f} ms (one launch a wave with every slot "
        f"formed: {K10_ONE_LAUNCH_A_WAVE_MS} ms, PERF.md), of which the window pass "
        f"window_store_planar {qs_ms:.3f} ms (outside the kernel; window store {store_mb:.1f} MB) "
        f"and the kernel {kernel_ms:.3f} ms in 1 launch (kineto); plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {windows} windows); no single library call replays "
        "wave-ordered windows (library_ms null)")
    return {
        "name": "apply_q2_planar_kernel", "route": "cuda",
        "source": "eigensolver_gpu_torch/csrc/replay_planar.cu",
        "replaces": "eigensolver_gpu_tpu/ops/replay_pallas.py:560",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _same_items(torch, got, one_of, batch):
    """True when item k of every batched output equals (torch.equal) the
    output of one_of(k), the unbatched launch on item k, for every k."""
    return all(all(torch.equal(x[k], y) for x, y in zip(got, one_of(k))) for k in range(batch))


def check_k6_batched(torch, entry):
    """K6 on a batch of panels in one launch (a cluster an item): the first
    psbrd panel of the batched cell at K1_BATCH ((1024, 32) column slices of
    64 planes of n = 1024, rb = 960, fp32), and 3 panels (1100, 16), rb =
    1000 in fp64 (four blocks an item, slabs across blocks). Each item
    bit-identical to its unbatched launch, within K6_TOL (K6_TOL64) of the
    plain version, one kernel a call (counter and profiler); times at batch
    64 against the bound of the batch's work. Adds the readings to K6's
    entry under "batched"."""
    import numpy as np

    from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar, ql_panel_planar_plain
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(66)
    batch, n, b = K1_BATCH, N_BATCHED, BAND
    big = torch.tensor(rng.standard_normal((2, batch, n, n)), dtype=torch.float32, device="cuda")
    wide = torch.tensor(rng.standard_normal((2, 3, 1100, 64)), device="cuda")
    cases = [(f"batch={batch} ({n}, {b}) rb={n - 2 * b} fp32 (the first psbrd panel at n={n})",
              big[0][:, :, n - b :], big[1][:, :, n - b :], n - 2 * b, K6_TOL),
             ("batch=3 (1100, 16) rb=1000 fp64 (four blocks an item)", wide[0][:, :, 7:23],
              wide[1][:, :, 7:23], 1000, K6_TOL64)]
    max_abs = 0.0
    for label, pr, pi, rb, tol in cases:
        ql_panel_planar.launches = 0
        got = ql_panel_planar(pr, pi, rb)
        launches = ql_panel_planar.launches
        want = ql_panel_planar_plain(pr, pi, rb)
        torch.cuda.synchronize()
        same = _same_items(torch, got, lambda k: ql_panel_planar(pr[k], pi[k], rb), pr.shape[0])
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if tol == K6_TOL:
            max_abs = max(max_abs, max(e[1] for e in errs))
        _, kernels = _kineto(torch, lambda: ql_panel_planar(pr, pi, rb), "ql_panel_planar_kernel")
        log(f"K6 batched {label}: one launch (counter {launches}, kineto {kernels}), every item "
            f"bit-identical to its unbatched launch: {same}, worst rel_err vs plain "
            f"{max(e[0] for e in errs):.1e}")
        if launches != 1 or kernels != 1 or not same or not max(e[0] for e in errs) <= tol:
            raise RuntimeError(f"batched K6 disagrees at {label}")
    _, pr, pi, rb, _ = cases[0]
    ms = device_ms(lambda: ql_panel_planar(pr, pi, rb), iters=20)
    one_ms = device_ms(lambda: ql_panel_planar(pr[0], pi[0], rb), iters=20)
    plain_ms = device_ms(lambda: ql_panel_planar_plain(pr, pi, rb), iters=2)
    nbytes, flops = _k6_work(n, b, rb, 4)
    bound_ms, bound_by = bound(batch * nbytes, batch * flops)
    log(f"K6 batched times at batch={batch} ({n}, {b}) rb={rb} fp32: kernel {ms:.4f} ms "
        f"({ms / batch * 1e3:.2f} us an item; one item alone {one_ms:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}); library_ms null")
    entry["batched"] = {"batch": batch, "shape": f"({n}, {b}) rb={rb} fp32", "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "max_abs_err": max_abs}


def _k8_moduli(torch, got, want):
    """Relative errors of an fp32 chase against its plain version as
    check_k8 holds them: the moduli d, |e|, |v|, |tau| on the first K7_HEAD
    sweeps, reflectors whose tau is 0 masked. Any leading batch axis rides
    along."""
    flat = lambda o: [o[0], o[1][0], o[1][1], o[2][0], o[2][1], o[3][0], o[3][1]]
    g, w = flat(got), flat(want)
    act = ((want[3][0] != 0) | (want[3][1] != 0))[..., None]
    for k in (3, 4):
        g[k], w[k] = g[k] * act, w[k] * act
    h = min(K7_HEAD, g[0].shape[-1] - 1)
    mod = lambda o: [o[0][..., :h], torch.hypot(o[1], o[2])[..., :h],
                     torch.hypot(o[3], o[4])[..., : 3 * h, :, :],
                     torch.hypot(o[5], o[6])[..., : 3 * h, :]]
    return [rel_err(x, y) for x, y in zip(mod(g), mod(w))]


def check_k8_batched(torch, entry):
    """K8 on a batch of bands in one launch: K1_BATCH bands at n = 1024,
    b = 32, fp32 (704 (item, slot) pairs on fewer blocks) and 2 at n = 2400,
    b = 6, fp64 (268 pairs, more than the SMs). Each item bit-identical to
    its unbatched launch; at batch 64 within K8_TOL of the plain version as
    check_k8 holds it; one kernel a call (counter and profiler); times
    against the bound. Adds the readings to K8's entry under "batched"."""
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel, chase_planar_blocks
    from eigensolver_gpu_torch.ops.sb2st import chase_dims
    from eigensolver_gpu_torch.ops.sb2st_planar import bulge_chase_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    flat = lambda o: [o[0], o[1][0], o[1][1], o[2][0], o[2][1], o[3][0], o[3][1]]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch, n, b, dtype in ((K1_BATCH, N_BATCHED, BAND, torch.float32),
                               (2, 2400, 6, torch.float64)):
        pairs = batch * chase_dims(n, b)[0]
        blocks = chase_planar_blocks(b, pairs, dtype)
        label = (f"batch={batch} n={n} b={b} {'fp32' if dtype == torch.float32 else 'fp64'} "
                 f"({pairs} pairs on {blocks} blocks, {sms} SMs)")
        planes = [_random_hband(torch, n, b, 80 + k, dtype)[:2] for k in range(batch)]
        band_r = torch.stack([p[0] for p in planes])
        band_i = torch.stack([p[1] for p in planes])
        del planes
        bulge_chase_planar_kernel.launches = 0
        got = bulge_chase_planar_kernel(band_r, band_i, b)
        launches = bulge_chase_planar_kernel.launches
        same = _same_items(torch, flat(got),
                           lambda k: flat(bulge_chase_planar_kernel(band_r[k], band_i[k], b)),
                           batch)
        _, kernels = _kineto(torch, lambda: bulge_chase_planar_kernel(band_r, band_i, b),
                             "chase_planar_kernel")
        msg = (f"K8 batched {label}: one launch (counter {launches}, kineto {kernels}), every "
               f"item bit-identical to its unbatched launch: {same}")
        if launches != 1 or kernels != 1 or not same or not blocks < pairs:
            log(msg)
            raise RuntimeError(f"batched K8 disagrees at {label}")
        if dtype == torch.float64:
            log(msg)
            continue
        want, plain_ms = _timed_once(torch, lambda: bulge_chase_planar(band_r, band_i, b))
        errs = _k8_moduli(torch, got, want)
        log(msg + f"; rel_err vs plain (moduli, first {K7_HEAD} sweeps) "
            + " ".join(f"{e[0]:.1e}" for e in errs))
        if not max(e[0] for e in errs) <= K8_TOL:
            raise RuntimeError(f"batched K8 disagrees with its plain version at {label}")
        ms = device_ms(lambda: bulge_chase_planar_kernel(band_r, band_i, b), iters=3)
        one_ms = device_ms(lambda: bulge_chase_planar_kernel(band_r[0], band_i[0], b), iters=3)
        nbytes, flops, windows = _k7_work(n, b, 4)
        bound_ms, bound_by = bound(batch * 2 * nbytes, batch * 4 * flops)
        log(f"K8 batched times at {label}: kernel {ms:.3f} ms (one item alone {one_ms:.3f} ms), "
            f"plain {plain_ms:.1f} ms (the batch through its tensors), bound {bound_ms:.4f} ms "
            f"({bound_by}; {windows} windows an item); library_ms null")
        entry["batched"] = {"batch": batch, "shape": f"n={n} b={b} fp32", "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": None, "max_abs_err": max(e[1] for e in errs)}


def check_k10_batched(torch, entry):
    """K10 on a batch of problems in one launch: K1_BATCH at n = m = 1024,
    b = 32, g = 96, fp32, and 3 at n = 1000, b = g = 24, m = 1, fp64. On the
    batch's window store each item's result is bit-identical to the launch
    on that item's windows alone (the zero fill past row n stays inside the
    item); the wrapper within K10_TOL (K10_TOL64) of the plain version; one
    kernel a call (counter and profiler); times at batch 64 against the
    bound. Adds the readings to K10's entry under "batched"."""
    import numpy as np

    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.replay import (
        apply_q2_planar_kernel,
        replay_planar_store,
        window_store_planar,
    )
    from eigensolver_gpu_torch.ops.sb2st_planar import apply_q2_planar
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(100)
    for batch, n, b, g, m, dtype, tol in ((K1_BATCH, N_BATCHED, BAND, REPLAY_G, N_BATCHED,
                                           torch.float32, K10_TOL),
                                          (3, 1000, 24, 24, 1, torch.float64, K10_TOL64)):
        label = (f"batch={batch} n={n} b={b} g={g} m={m} "
                 f"{'fp32' if dtype == torch.float32 else 'fp64'}")
        planes = [_random_hband(torch, n, b, 100 + k, dtype)[:2] for k in range(batch)]
        _, _, vt, taut = bulge_chase_planar_kernel(torch.stack([p[0] for p in planes]),
                                                   torch.stack([p[1] for p in planes]), b)
        del planes
        y = tuple(torch.tensor(rng.standard_normal((batch, n, m)), dtype=dtype, device="cuda")
                  for _ in range(2))
        apply_q2_planar_kernel.launches = 0
        got = apply_q2_planar_kernel(vt, taut, y, n, b, g=g)
        launches = apply_q2_planar_kernel.launches
        want = apply_q2_planar(vt, taut, y, n, b, g=g)
        torch.cuda.synchronize()
        errs = [rel_err(x, w) for x, w in zip(got, want)]
        moved = min(rel_err(w, y0)[0] for w, y0 in zip(want, y))
        del want
        store, table = window_store_planar(vt, taut, n, b, g)
        row0 = torch.tensor(table["row0"], dtype=torch.int32, device="cuda")
        l_win = table["geo"]["l_win"]
        both = replay_planar_store(store, row0, y, l_win)
        same = _same_items(torch, both,
                           lambda k: replay_planar_store(store[:, k], row0, (y[0][k], y[1][k]),
                                                         l_win), batch)
        _, kernels = _kineto(torch, lambda: replay_planar_store(store, row0, y, l_win),
                             "replay_planar_kernel")
        log(f"K10 batched {label}: one launch (counter {launches}, kineto {kernels}), every item "
            f"bit-identical to the launch on its windows alone: {same}, rel_err vs plain "
            f"re={errs[0][0]:.2e} im={errs[1][0]:.2e} (plain vs its input {moved:.2e}); window "
            f"store {store.numel() * store.element_size() / 1e6:.1f} MB ({len(table['row0'])} "
            f"windows an item)")
        if launches != 1 or kernels != 1 or not same or not max(e[0] for e in errs) <= tol \
                or not moved > 0.1:
            raise RuntimeError(f"batched K10 disagrees at {label}")
        if dtype != torch.float32:
            continue
        max_abs = max(e[1] for e in errs)
        del got, both
        ms = device_ms(lambda: apply_q2_planar_kernel(vt, taut, y, n, b, g=g), iters=3)
        qs_ms = device_ms(lambda: window_store_planar(vt, taut, n, b, g), iters=3)
        kernel_ms, _ = _kineto(torch, lambda: replay_planar_store(store, row0, y, l_win),
                               "replay_planar_kernel")
        del store
        plain_ms = device_ms(lambda: apply_q2_planar(vt, taut, y, n, b, g=g), iters=1)
        nbytes, flops, windows = _k9_work(n, m, b, g, 4)
        bound_ms, bound_by = bound(batch * 2 * nbytes, batch * 4 * flops)
        log(f"K10 batched times at {label}: wrapper {ms:.3f} ms, of which the window pass "
            f"window_store_planar {qs_ms:.3f} ms and the kernel {kernel_ms:.3f} ms in 1 launch "
            f"(kineto); plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {windows} "
            "windows an item); library_ms null")
        entry["batched"] = {"batch": batch, "shape": f"n=m={n} b={b} g={g} fp32", "ms": ms,
                            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": None, "max_abs_err": max_abs}


def check_k5_batched(torch, entry):
    """K5 on a batch of panels in one launch (a cluster an item): the first
    sbrd panel of the real batched cell at K1_BATCH ((1024, 32) column
    slices of 64 matrices of n = 1024, rb = 960, fp32), and 3 panels
    (1100, 16), rb = 1000 in fp64 (five blocks an item, slabs across
    blocks). Each item bit-identical to its unbatched launch, within K5_TOL
    (K5_TOL64) of the plain version, one kernel a call (counter and
    profiler); times at batch 64 against the bound of the batch's work. Adds
    the readings to K5's entry under "batched"."""
    import numpy as np

    from eigensolver_gpu_torch.ops.ql_panel import ql_panel, ql_panel_plain
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(55)
    batch, n, b = K1_BATCH, N_BATCHED, BAND
    big = torch.tensor(rng.standard_normal((batch, n, n)), dtype=torch.float32, device="cuda")
    wide = torch.tensor(rng.standard_normal((3, 1100, 64)), device="cuda")
    cases = [(f"batch={batch} ({n}, {b}) rb={n - 2 * b} fp32 (the first sbrd panel at n={n})",
              big[:, :, n - b :], n - 2 * b, K5_TOL),
             ("batch=3 (1100, 16) rb=1000 fp64 (five blocks an item)", wide[:, :, 7:23], 1000,
              K5_TOL64)]
    max_abs = 0.0
    for label, p, rb, tol in cases:
        ql_panel.launches = 0
        got = ql_panel(p, rb)
        launches = ql_panel.launches
        want = ql_panel_plain(p, rb)
        torch.cuda.synchronize()
        same = _same_items(torch, got, lambda k: ql_panel(p[k], rb), p.shape[0])
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if tol == K5_TOL:
            max_abs = max(max_abs, max(e[1] for e in errs))
        _, kernels = _kineto(torch, lambda: ql_panel(p, rb), "ql_panel_kernel")
        log(f"K5 batched {label}: one launch (counter {launches}, kineto {kernels}), every item "
            f"bit-identical to its unbatched launch: {same}, worst rel_err vs plain "
            f"{max(e[0] for e in errs):.1e}")
        if launches != 1 or kernels != 1 or not same or not max(e[0] for e in errs) <= tol:
            raise RuntimeError(f"batched K5 disagrees at {label}")
    _, p, rb, _ = cases[0]
    ms = device_ms(lambda: ql_panel(p, rb), iters=20)
    one_ms = device_ms(lambda: ql_panel(p[0], rb), iters=20)
    plain_ms = device_ms(lambda: ql_panel_plain(p, rb), iters=2)
    nbytes, flops = _k5_work(n, b, rb, 4)
    bound_ms, bound_by = bound(batch * nbytes, batch * flops)
    log(f"K5 batched times at batch={batch} ({n}, {b}) rb={rb} fp32: kernel {ms:.4f} ms "
        f"({ms / batch * 1e3:.2f} us an item; one item alone {one_ms:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}); library_ms null")
    entry["batched"] = {"batch": batch, "shape": f"({n}, {b}) rb={rb} fp32", "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "max_abs_err": max_abs}


def check_k7_batched(torch, entry):
    """K7 on a batch of bands in one launch: K1_BATCH bands at n = 1024,
    b = 32, fp32 (704 (item, slot) pairs on fewer blocks) and 2 at n = 2400,
    b = 6, fp64 (268 pairs, more than the SMs). Each item bit-identical to
    its unbatched launch; at batch 64 within K7_TOL of the plain version on
    d, |e|, |vt| and taut of the first K7_HEAD sweeps, as check_k7 holds
    it; one kernel a call (counter and profiler); times against the bound.
    Adds the readings to K7's entry under "batched"."""
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel, chase_blocks
    from eigensolver_gpu_torch.ops.sb2st import bulge_chase, chase_dims
    from eigensolver_gpu_torch.utils.timer import device_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch, n, b, dtype in ((K1_BATCH, N_BATCHED, BAND, torch.float32),
                               (2, 2400, 6, torch.float64)):
        pairs = batch * chase_dims(n, b)[0]
        blocks = chase_blocks(b, pairs, dtype)
        label = (f"batch={batch} n={n} b={b} {'fp32' if dtype == torch.float32 else 'fp64'} "
                 f"({pairs} pairs on {blocks} blocks, {sms} SMs)")
        band = torch.stack([_random_band(torch, n, b, 70 + k, dtype)[0] for k in range(batch)])
        bulge_chase_kernel.launches = 0
        got = bulge_chase_kernel(band, b)
        launches = bulge_chase_kernel.launches
        same = _same_items(torch, got, lambda k: bulge_chase_kernel(band[k], b), batch)
        _, kernels = _kineto(torch, lambda: bulge_chase_kernel(band, b), "chase_kernel")
        msg = (f"K7 batched {label}: one launch (counter {launches}, kineto {kernels}), every "
               f"item bit-identical to its unbatched launch: {same}")
        if launches != 1 or kernels != 1 or not same or not blocks < pairs:
            log(msg)
            raise RuntimeError(f"batched K7 disagrees at {label}")
        if dtype == torch.float64:
            log(msg)
            continue
        want, plain_ms = _timed_once(torch, lambda: bulge_chase(band, b))
        act = (want[3] != 0)[..., None]
        h = K7_HEAD
        errs = [rel_err(x, y) for x, y in (
            (got[0][..., :h], want[0][..., :h]), (got[1][..., :h].abs(), want[1][..., :h].abs()),
            ((got[2] * act)[..., : 3 * h, :, :].abs(), (want[2] * act)[..., : 3 * h, :, :].abs()),
            (got[3][..., : 3 * h, :], want[3][..., : 3 * h, :]))]
        log(msg + f"; rel_err vs plain (d, |e|, |vt|, taut, first {h} sweeps) "
            + " ".join(f"{e[0]:.1e}" for e in errs))
        if not max(e[0] for e in errs) <= K7_TOL:
            raise RuntimeError(f"batched K7 disagrees with its plain version at {label}")
        ms = device_ms(lambda: bulge_chase_kernel(band, b), iters=3)
        one_ms = device_ms(lambda: bulge_chase_kernel(band[0], b), iters=3)
        nbytes, flops, windows = _k7_work(n, b, 4)
        bound_ms, bound_by = bound(batch * nbytes, batch * flops)
        log(f"K7 batched times at {label}: kernel {ms:.3f} ms (one item alone {one_ms:.3f} ms), "
            f"plain {plain_ms:.1f} ms (the batch through its tensors), bound {bound_ms:.4f} ms "
            f"({bound_by}; {windows} windows an item); library_ms null")
        entry["batched"] = {"batch": batch, "shape": f"n={n} b={b} fp32", "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": None, "max_abs_err": max(e[1] for e in errs)}


def check_k9_batched(torch, entry):
    """K9 on a batch of problems in one launch: K1_BATCH at n = m = 1024,
    b = 32, g = 96, fp32, and 3 at n = 1000, b = g = 24, m = 1, fp64. On the
    batch's window store each item's result is bit-identical to the launch
    on that item's windows alone (the zero fill past row n stays inside the
    item); the wrapper within K9_TOL (K9_TOL64) of the plain version; one
    kernel a call (counter and profiler); times at batch 64 against the
    bound. Adds the readings to K9's entry under "batched"."""
    import numpy as np

    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, replay_store, window_store
    from eigensolver_gpu_torch.ops.sb2st import apply_q2
    from eigensolver_gpu_torch.utils.timer import device_ms

    rng = np.random.default_rng(90)
    for batch, n, b, g, m, dtype, tol in ((K1_BATCH, N_BATCHED, BAND, REPLAY_G, N_BATCHED,
                                           torch.float32, K9_TOL),
                                          (3, 1000, 24, 24, 1, torch.float64, K9_TOL64)):
        label = (f"batch={batch} n={n} b={b} g={g} m={m} "
                 f"{'fp32' if dtype == torch.float32 else 'fp64'}")
        band = torch.stack([_random_band(torch, n, b, 90 + k, dtype)[0] for k in range(batch)])
        _, _, vt, taut = bulge_chase_kernel(band, b)
        del band
        y = torch.tensor(rng.standard_normal((batch, n, m)), dtype=dtype, device="cuda")
        apply_q2_kernel.launches = 0
        got = apply_q2_kernel(vt, taut, y, n, b, g=g)
        launches = apply_q2_kernel.launches
        want = apply_q2(vt, taut, y, n, b, g=g)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        moved = rel_err(want, y)[0]
        del want
        store, table = window_store(vt, taut, n, b, g)
        row0 = torch.tensor(table["row0"], dtype=torch.int32, device="cuda")
        l_win = table["geo"]["l_win"]
        both = replay_store(store, row0, y, l_win)
        same = all(torch.equal(both[k], replay_store(store[k], row0, y[k], l_win))
                   for k in range(batch))
        _, kernels = _kineto(torch, lambda: replay_store(store, row0, y, l_win), "replay_kernel")
        log(f"K9 batched {label}: one launch (counter {launches}, kineto {kernels}), every item "
            f"bit-identical to the launch on its windows alone: {same}, rel_err vs plain "
            f"{rel:.2e} (plain vs its input {moved:.2e}); window store "
            f"{store.numel() * store.element_size() / 1e6:.1f} MB ({len(table['row0'])} windows "
            "an item)")
        if launches != 1 or kernels != 1 or not same or not rel <= tol or not moved > 0.1:
            raise RuntimeError(f"batched K9 disagrees at {label}")
        if dtype != torch.float32:
            continue
        del got, both
        ms = device_ms(lambda: apply_q2_kernel(vt, taut, y, n, b, g=g), iters=3)
        qs_ms = device_ms(lambda: window_store(vt, taut, n, b, g), iters=3)
        kernel_ms, _ = _kineto(torch, lambda: replay_store(store, row0, y, l_win),
                               "replay_kernel")
        del store
        plain_ms = device_ms(lambda: apply_q2(vt, taut, y, n, b, g=g), iters=1)
        nbytes, flops, windows = _k9_work(n, m, b, g, 4)
        bound_ms, bound_by = bound(batch * nbytes, batch * flops)
        log(f"K9 batched times at {label}: wrapper {ms:.3f} ms, of which the window pass "
            f"window_store {qs_ms:.3f} ms and the kernel {kernel_ms:.3f} ms in 1 launch "
            f"(kineto); plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {windows} "
            "windows an item); library_ms null")
        entry["batched"] = {"batch": batch, "shape": f"n=m={n} b={b} g={g} fp32", "ms": ms,
                            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": None, "max_abs_err": err}


def _window_store_mb(n, b, g):
    """MB of K10's fp32 window store at (n, b, g): two planes of 128 x 128
    for each valid window."""
    from eigensolver_gpu_torch.ops.replay import P, window_table

    return 2 * len(window_table(n, b, g)["row0"]) * P * P * 4 / 1e6


def _device_residual(torch, args, res):
    """bench.py's residual of the complex problem, in planar arithmetic on
    the device: max_k ||A z_k - w_k B z_k|| / (n * max row 1-norm of A);
    for a batch (leading axis) each item against its own A, the largest
    item's value returned."""
    ar, ai, br, bi = args
    w, zr, zi = res.w, res.zr, res.zi
    n = ar.shape[-1]
    rr = ar @ zr - ai @ zi - (br @ zr - bi @ zi) * w[..., None, :]
    ri = ar @ zi + ai @ zr - (br @ zi + bi @ zr) * w[..., None, :]
    r2 = torch.sum(rr * rr + ri * ri, dim=-2)
    anorm = torch.amax(torch.sum(torch.sqrt(ar * ar + ai * ai), dim=-1), dim=-1)
    return float(torch.max(torch.amax(torch.sqrt(r2), dim=-1) / (n * anorm)))


def _synced(torch, solve):
    """One solve with synchronizing trace ranges: (result, stage ms by
    range name, wall ms)."""
    from eigensolver_gpu_torch.utils import tracing

    tracing.clear()
    tracing.enable(sync=True)
    try:
        res, ms = _timed_once(torch, solve)
    finally:
        tracing.disable()
    stages = {}
    for name, sec in tracing.timings():
        stages[name] = stages.get(name, 0.0) + sec * 1e3
    tracing.clear()
    return res, stages, ms


def _breakdown(torch, solve, wall, kernels=(), stages=None, profiled=True):
    """One solve with synchronizing trace ranges (stage ms; ``stages``, if
    given, is such a solve's already), then, if ``profiled``, one under
    torch.profiler: device busy ms (sum of kernel self times), the idle
    share against the unprofiled wall time ``wall``, the top kernels, and
    the device total of every kernel whose name holds one of ``kernels``.
    Returns the stage ms by range name and, for each of ``kernels``, its
    (device ms, launches) over the profiled solve."""
    if stages is None:
        _, stages, _ = _synced(torch, solve)
    if not profiled:
        log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
        log("  device busy: not measured in this run (see the caller)")
        return stages, {}
    # device activity only, read from the raw kineto records: building
    # the profiler's per-op event tree for ~10^5 small ops takes minutes
    per_kernel = {}  # name -> [ms, count]; one stream, so times add up
    for name, ns in _device_records(torch, solve, kernels):
        acc = per_kernel.setdefault(name, [0.0, 0])
        acc[0] += ns / 1e6
        acc[1] += 1
    busy = sum(v[0] for v in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    top = ", ".join(f"{k[:48]}={v[0]:.1f}ms/{v[1]}" for k, v in ranked)
    idle = f"{1.0 - busy / wall:.3f}" if busy > 0 else "not measured"
    log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    log(f"  device busy {busy:.1f} ms of {wall:.1f} ms wall, idle share {idle}; top: {top}")
    totals = {}
    for key in kernels:
        hits = [v for k, v in per_kernel.items() if key in k]
        totals[key] = (sum(v[0] for v in hits), sum(v[1] for v in hits))
        log(f"  kernel {key}: {totals[key][0]:.2f} ms device time in "
            f"{totals[key][1]} launches over one solve (kineto)")
    log(f"  kernel launches over one solve (kineto): {sum(v[1] for v in per_kernel.values())}")
    return stages, totals


def phase_main(torch):
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy
    from eigensolver_gpu_torch.utils.timer import wall_ms

    a, b = _pair("random_hpd_pair", N_MAIN, 0)
    args = planar_from_numpy(a, b, device="cuda", dtype=torch.float64)
    del a, b
    launches = {}
    for use_pallas, want_k2 in ((False, 0), (True, 64)):
        cfg = SolverConfig(compute_dtype="float32", use_pallas=use_pallas)
        solve = lambda: zhegvdx_planar(*args, il=1, iu=IU_MAIN, cfg=cfg)
        pchol_block_planar.launches = 0
        latrd_panel_planar.launches = 0
        # the second configuration's first solve, warm, is its synchronized one
        stages = None
        if use_pallas:
            res, stages, first_ms = _synced(torch, solve)
        else:
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
        if use_pallas:
            times = wall_ms(solve, iters=1)
        else:  # the timed solve is the synchronized one: a few stage ranges
            _, stages, synced_ms = _synced(torch, solve)
            times = [synced_ms]
        log(f"main use_pallas={use_pallas}: n={N_MAIN} iu={IU_MAIN} info={info} "
            f"residual={resid:.3e} first{' (synchronizing ranges)' if use_pallas else ''}="
            f"{first_ms:.1f} ms timed{'' if use_pallas else ' (synchronizing ranges)'}="
            f"{[round(x, 1) for x in times]} ms "
            f"launches K1={k1} K2={k2} peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if info != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(f"main path wrong: info={info} finite={finite} residual={resid}")
        if shapes != ((IU_MAIN,), (N_MAIN, IU_MAIN), (N_MAIN, IU_MAIN)):
            raise RuntimeError(f"main path shapes {shapes}")
        if k1 != N_MAIN // 128 or k2 != want_k2:
            raise RuntimeError(f"launch counts K1={k1} K2={k2}, want {N_MAIN // 128} and {want_k2}")
        # the use_pallas=False solve is not profiled: its ~6.6e5 launches cost
        # about 40 s under the profiler on an H100, and its device busy time
        # is the same from run to run (1341.1-1341.2 ms on an H100)
        _, totals = _breakdown(torch, solve, min(times), stages=stages,
                               kernels=("latrd_",) if use_pallas else (), profiled=use_pallas)
        if use_pallas and totals["latrd_"][1] != want_k2:
            raise RuntimeError(f"one use_pallas solve launched {totals['latrd_'][1]} K2 kernels "
                               f"(kineto), want {want_k2}: one a panel")
    return launches


def phase_reference(torch):
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar_host
    from eigensolver_gpu_torch.utils.testing import ge_residual

    a, b = _pair("random_hpd_pair", N_REF, 1)
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
    from eigensolver_gpu_torch.utils.timer import wall_ms

    n, iu = N_REAL, IU_REAL
    a, b = dense_from_numpy(*_pair("random_spd_pair", n, 0), device="cuda", dtype=torch.float64)
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
        # the second configuration's first solve, warm, is its synchronized one
        stages = None
        if use_pallas:
            res, stages, first_ms = _synced(torch, solve)
        else:
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
        if use_pallas:
            times = wall_ms(solve, iters=1)
        else:  # the timed solve is the synchronized one: a few stage ranges
            _, stages, synced_ms = _synced(torch, solve)
            times = [synced_ms]
        log(f"main real use_pallas={use_pallas}: n={n} iu={iu} info={info} "
            f"residual={resid:.3e} first{' (synchronizing ranges)' if use_pallas else ''}="
            f"{first_ms:.1f} ms timed{'' if use_pallas else ' (synchronizing ranges)'}="
            f"{[round(x, 1) for x in times]} ms "
            f"launches K4={k4} peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if info != 0 or not finite or not resid <= 1e-13:
            raise RuntimeError(f"real path wrong: info={info} finite={finite} residual={resid}")
        if shapes != ((iu,), (n, iu)) or res.w.dtype != torch.float64:
            raise RuntimeError(f"real path shapes {shapes} dtype {res.w.dtype}")
        if k4 != want_k4:
            raise RuntimeError(f"launch count K4={k4}, want {want_k4}")
        # the use_pallas=False solve is not profiled, as in phase_main (its
        # device busy time: 491.8-492.9 ms on an H100)
        stages, totals = _breakdown(torch, solve, min(times), stages=stages,
                                    kernels=("symv_kernel",) if use_pallas else (),
                                    profiled=use_pallas)
        if use_pallas:
            k4_ms, k4_n = totals["symv_kernel"]
            # the kernel's calls: extents mb-256 .. mb-1 of each 512-aligned bucket
            k4_bound = sum(_mv_bound(c, 1)[0] for mb in range(512, n + 1, 512)
                           for c in range(mb - 256, mb))
            log(f"  K4 over one solve (kineto): {k4_ms:.3f} ms in {k4_n} launches, "
                f"{k4_ms / max(k4_n, 1) * 1e3:.2f} us a launch; its calls' bound "
                f"{k4_bound:.2f} ms (bytes)")
        # the fp32 pipeline's sygvdx range holds Cholesky, sygst, syevdx
        # and the phase-4 solve; syevdx holds sytrd, stedc and unmtr
        log(f"  Cholesky + sygst + phase 4: {stages['sygvdx'] - stages['syevdx']:.1f} ms")
    return k4


def phase_main_real_two(torch):
    """dsygvdx n=4096 il=1..iu=512 mp with tridiag_mode='two': warm-up + 3
    timed solves through K5, K7 and K9, then one n=512 iu=64 solve by the
    plain torch route (mosaic_kernels=False; its eager chase takes about a
    millisecond a timestep, 12 s at n=4096). Returns the kernels' launches
    per solve."""
    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel
    from eigensolver_gpu_torch.utils.convert import dense_from_numpy
    from eigensolver_gpu_torch.utils.timer import wall_ms

    n, iu = N_REAL, IU_REAL
    a, b = dense_from_numpy(*_pair("random_spd_pair", n, 0), device="cuda", dtype=torch.float64)

    def check(res, what, a, b, iu):
        n = a.shape[-1]
        anorm = torch.max(torch.sum(a.abs(), dim=1))
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
    resid = check(res, "two-stage real path", a, b, iu)
    times = wall_ms(solve, iters=3)
    log(f"main real two-stage mosaic_kernels=True: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"first={first_ms:.1f} ms timed={[round(x, 1) for x in times]} ms launches "
        f"K5={counts['ql_panel']} K7={counts['bulge_chase_kernel']} K9={counts['apply_q2_kernel']} "
        f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"ql_panel": n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
    if counts != want:
        raise RuntimeError(f"launch counts {counts}, want {want}")
    stages, totals = _breakdown(torch, solve, sorted(times)[1],
                                kernels=("ql_panel_kernel", "chase_kernel", "replay_kernel"))
    log(f"  Cholesky + sygst + phase 4: {stages['sygvdx'] - stages['syevdx']:.1f} ms")
    log(f"  K7 and K9 launches per real two-stage solve (kineto): {totals['chase_kernel'][1]} "
        f"and {totals['replay_kernel'][1]}")
    for key in ("chase_kernel", "replay_kernel"):
        if totals[key][1] != 1:
            raise RuntimeError(f"one real two-stage solve launched {key} {totals[key][1]} "
                               "times (kineto), want 1")

    # the plain torch route, one solve at N_PLAIN_ROUTE, with synchronizing ranges
    n, iu = N_PLAIN_ROUTE, IU_REF_REAL
    a_plain, b_plain = dense_from_numpy(*_pair("random_spd_pair", n, 0), device="cuda",
                                        dtype=torch.float64)
    cfg_plain = SolverConfig(compute_dtype="float32", tridiag_mode="two", mosaic_kernels=False)
    for fn in wrappers:
        fn.launches = 0
    res, stages, plain_ms = _synced(
        torch, lambda: dsygvdx(a_plain, b_plain, il=1, iu=iu, cfg=cfg_plain))
    resid = check(res, "two-stage real path (plain route)", a_plain, b_plain, iu)
    if any(fn.launches for fn in wrappers):
        raise RuntimeError("mosaic_kernels=False launched a kernel of the two-stage path")
    log(f"main real two-stage mosaic_kernels=False: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"one solve with synchronizing ranges {plain_ms:.1f} ms")
    log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    return counts


def phase_main_planar_two(torch):
    """zhegvdx n=4096 il=1..iu=1024 mp with tridiag_mode='two': one solve that
    counts launches, 3 timed solves through K1, K6, K8 and K10, the stage
    breakdown; then one n=512 solve by the plain torch route
    (mosaic_kernels=False), which must launch none of them. Returns the
    kernels' launches per solve."""
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy
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
    args = planar_from_numpy(*_pair("random_hpd_pair", n, 0), device="cuda", dtype=torch.float64)
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
    _, totals = _breakdown(torch, solve, sorted(times)[1],
                           kernels=("pchol_block_kernel", "ql_panel_planar_kernel",
                                    "chase_planar_kernel", "replay_planar_kernel"))
    _log_stedc("  stedc of the last solve")
    log(f"  K10 launches per planar two-stage solve (kineto): "
        f"{totals['replay_planar_kernel'][1]}; its window store "
        f"{_window_store_mb(n, BAND, REPLAY_G):.1f} MB")
    for key in ("chase_planar_kernel", "replay_planar_kernel"):
        if totals[key][1] != 1:
            raise RuntimeError(f"one planar two-stage solve launched {key} {totals[key][1]} "
                               "times (kineto), want 1")
    del args, res

    # the plain torch route, one solve, with synchronizing ranges
    n, iu = N_PLAIN_ROUTE, N_PLAIN_ROUTE // 4
    args = planar_from_numpy(*_pair("random_hpd_pair", n, 2), device="cuda", dtype=torch.float64)
    cfg_plain = SolverConfig(compute_dtype="float32", tridiag_mode="two", mosaic_kernels=False)
    for fn in wrappers:
        fn.launches = 0
    res, stages, plain_ms = _synced(
        torch, lambda: zhegvdx_planar(*args, il=1, iu=iu, cfg=cfg_plain))
    resid = check(args, res, n, iu, "planar two-stage path (plain route)")
    if any(fn.launches for fn in wrappers):
        raise RuntimeError("mosaic_kernels=False launched a kernel of the planar two-stage path: "
                           f"{ {fn.__name__: fn.launches for fn in wrappers} }")
    log(f"main planar two-stage mosaic_kernels=False: n={n} iu={iu} info=0 residual={resid:.3e} "
        f"one solve with synchronizing ranges {plain_ms:.1f} ms, no kernel launched")
    log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    return {k: v for k, v in counts.items() if k in (
        "ql_panel_planar", "bulge_chase_planar_kernel", "apply_q2_planar_kernel")}


def _held_items(torch, got, want, what):
    """One batched item against its unbatched solve: eigenvalues within
    1e-12 relative to max |w|, vectors phase-insensitively (compare_vectors)
    within 1e-8. Returns (eigenvalue error, vector distance)."""
    from eigensolver_gpu_torch.utils.testing import compare_vectors

    gw, gz = got
    ww, wz = want
    werr = float((gw - ww).abs().max() / ww.abs().max())
    vdist = compare_vectors(gz.cpu().numpy(), wz.cpu().numpy())
    if not werr <= 1e-12 or not vdist <= 1e-8:
        raise RuntimeError(f"{what}: eigenvalues {werr:.3e}, vectors {vdist:.3e} from the "
                           f"unbatched solve")
    return werr, vdist


def phase_main_batched(torch):
    """The k-point batch (BASELINE config 4): zhegvdx_planar_batched on 64
    distinct pairs random_hpd_pair(1024, seed=k), il=1..iu=128, mode mp;
    items 0 and 63 against the unbatched solve; then sygvdx_batched on
    64 x random_spd_pair(1024, seed=k), iu=64, mp; then a batch of 4 whose
    item 2 has a B that is not positive definite. Returns K1's launches
    over one batched solve and the batched solve's wall ms."""
    import numpy as np

    from eigensolver_gpu_torch import (
        SolverConfig,
        sygvdx,
        sygvdx_batched,
        zhegvdx_planar,
        zhegvdx_planar_batched,
    )
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.utils.timer import wall_ms

    batch, n, iu = K1_BATCH, N_BATCHED, IU_BATCHED
    cfg = SolverConfig(compute_dtype="float32", refine_iters=2)
    args = _kpoint_batch(torch, "main (batched)")
    want_k1 = n // 128

    # chunk 8 (the same solve chunk by chunk, 25 s of host-paced column loops)
    # is driven by phase 14, on the two-stage route
    solve = lambda: zhegvdx_planar_batched(*args, il=1, iu=iu, cfg=cfg)
    pchol_block_planar.launches = 0
    torch.cuda.reset_peak_memory_stats()
    full, first_ms = _timed_once(torch, solve)
    batched_k1 = pchol_block_planar.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    info = full.info.cpu().tolist()
    resid = _device_residual(torch, args, full)
    finite = bool(torch.isfinite(full.w).all() and torch.isfinite(full.zr).all()
                  and torch.isfinite(full.zi).all())
    shapes = (tuple(full.w.shape), tuple(full.zr.shape), tuple(full.zi.shape),
              tuple(full.info.shape))
    times = wall_ms(solve, iters=1)
    one_stage_ms = min(times)
    log(f"main (batched) chunk=None: {batch} x n={n} iu={iu} mp: info all 0: "
        f"{set(info) == {0}}, residual (max over items) {resid:.3e}, first {first_ms:.1f} ms, "
        f"timed {[round(x, 1) for x in times]} ms = {one_stage_ms / batch:.2f} ms a problem, "
        f"K1 launches {batched_k1}, peak memory {peak:.2f} GiB")
    if set(info) != {0} or not finite or not resid <= 1e-13:
        raise RuntimeError(f"batched path wrong: info={info} finite={finite} residual={resid}")
    if shapes != ((batch, iu), (batch, n, iu), (batch, n, iu), (batch,)):
        raise RuntimeError(f"batched path shapes {shapes}")
    if batched_k1 != want_k1:
        raise RuntimeError(f"K1 launched {batched_k1} times, want {want_k1}: one a block "
                           "step for the whole batch")
    _, totals = _breakdown(torch, solve, one_stage_ms, kernels=("pchol",))
    if totals["pchol"][1] != want_k1:
        raise RuntimeError(f"one batched solve ran {totals['pchol'][1]} K1 kernels "
                           f"(kineto), want {want_k1}")

    for k in (0, batch - 1):  # the two-stage phase holds 0, 21, 42, 63
        item = tuple(x[k] for x in args)
        one = lambda: zhegvdx_planar(*item, il=1, iu=iu, cfg=cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = one()
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        werr, vdist = _held_items(torch, (full.w[k], torch.complex(full.zr[k], full.zi[k])),
                                  (single.w, torch.complex(single.zr, single.zi)), f"item {k}")
        extra = ""
        if k == 0:
            extra = f"; its unbatched solve {min(wall_ms(one, iters=1)):.1f} ms (first {single_ms:.1f})"
        log(f"  item {k} against its unbatched solve: eigenvalues {werr:.2e} relative, "
            f"vectors {vdist:.2e}, info {int(single.info)}{extra}")

    # the same batch with planar_solve_mode='trinv'
    cfg_t = SolverConfig(compute_dtype="float32", refine_iters=2, planar_solve_mode="trinv")
    pchol_block_planar.launches = 0
    res_t, trinv_ms = _timed_once(
        torch, lambda: zhegvdx_planar_batched(*args, il=1, iu=iu, cfg=cfg_t))
    k1_t = pchol_block_planar.launches
    resid_t = _device_residual(torch, args, res_t)
    info_t = res_t.info.cpu().tolist()
    log(f"main (batched) planar_solve_mode=trinv: {batch} x n={n} iu={iu} mp: info all 0: "
        f"{set(info_t) == {0}}, residual (max over items) {resid_t:.3e}, one solve "
        f"{trinv_ms:.1f} ms, K1 launches {k1_t}")
    _log_stedc("  stedc of the trinv batch")
    if set(info_t) != {0} or not resid_t <= 1e-13 or k1_t != want_k1:
        raise RuntimeError(f"batched trinv wrong: info={info_t} residual={resid_t} K1={k1_t}")
    for k in (0, batch - 1):
        single = zhegvdx_planar(*(x[k] for x in args), il=1, iu=iu, cfg=cfg_t)
        werr, vdist = _held_items(torch, (res_t.w[k], torch.complex(res_t.zr[k], res_t.zi[k])),
                                  (single.w, torch.complex(single.zr, single.zi)),
                                  f"trinv item {k}")
        log(f"  trinv item {k} against its unbatched trinv solve: eigenvalues {werr:.2e} "
            f"relative, vectors {vdist:.2e}")
    del res_t

    # the first four pairs with B not positive definite in item 2
    bad = tuple(x[:4].clone() for x in args)
    bad[2][2, 9, 9] = -50.0
    res4 = zhegvdx_planar_batched(*bad, il=1, iu=iu, cfg=cfg)
    one = zhegvdx_planar(*(x[2] for x in bad), il=1, iu=iu, cfg=cfg)
    info4 = res4.info.cpu().tolist()
    log(f"  batch of 4 with a non-PD B in item 2: info {info4}, unbatched item 2 info "
        f"{int(one.info)}")
    if info4[2] <= 0 or info4[2] != int(one.info) or info4[:2] + info4[3:] != [0, 0, 0]:
        raise RuntimeError(f"non-PD item: info {info4}, unbatched {int(one.info)}")
    for k in (0, 1, 3):  # as in the batch of 64
        _held_items(torch, (res4.w[k], torch.complex(res4.zr[k], res4.zi[k])),
                    (full.w[k], torch.complex(full.zr[k], full.zi[k])), f"non-PD batch item {k}")
    del args, bad, res4, full

    # the real k-point batch (BASELINE config 1, batched)
    t0 = time.perf_counter()
    pairs = _pairs("random_spd_pair", n, batch)
    a = torch.tensor(np.stack([p[0] for p in pairs]), device="cuda")
    b = torch.tensor(np.stack([p[1] for p in pairs]), device="cuda")
    del pairs
    log(f"main (batched, real): {batch} x random_spd_pair({n}, seed=k) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    iu_r = IU_BATCHED_REAL
    solve = lambda: sygvdx_batched(a, b, il=1, iu=iu_r, cfg=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    times = wall_ms(solve, iters=1)
    resid = _real_residual(torch, a, b, res)
    info = res.info.cpu().tolist()
    log(f"main (batched, real): {batch} x n={n} iu={iu_r} mp: info all 0: {set(info) == {0}}, "
        f"residual {resid:.3e}, first {first_ms:.1f} ms, timed "
        f"{[round(x, 1) for x in times]} ms = {min(times) / batch:.2f} ms a problem")
    if set(info) != {0} or not resid <= 1e-13 or tuple(res.z.shape) != (batch, n, iu_r):
        raise RuntimeError(f"batched real path wrong: info={info} residual={resid}")
    for k in (0, batch - 1):
        one = lambda: sygvdx(a[k], b[k], il=1, iu=iu_r, cfg=cfg)
        single = one()
        werr, vdist = _held_items(torch, (res.w[k], res.z[k]), (single.w, single.z),
                                  f"real item {k}")
        log(f"  real item {k} against its unbatched solve: eigenvalues {werr:.2e} relative, "
            f"vectors {vdist:.2e}; unbatched {min(wall_ms(one, iters=1)):.1f} ms")
    return {"k1_batched": batched_k1, "batched_one_stage_ms": one_stage_ms,
            "batched_real_one_stage_ms": min(times)}


_HOST_PAIRS = {}  # (fixture name, n, seed) -> the pair, made once in this process


def _pair(make, n, seed):
    """utils.testing's fixture ``make`` (its name; "draws": the normal draws
    of random_spd_pair, _spd_draws) at (n, seed), made once in this process
    (see _prepare)."""
    import eigensolver_gpu_torch.utils.testing as fixtures

    key = (make, n, seed)
    if key not in _HOST_PAIRS:
        fixture = _spd_draws if make == "draws" else getattr(fixtures, make)
        _HOST_PAIRS[key] = fixture(n, seed=seed)
    return _HOST_PAIRS[key]


def _pairs(make, n, batch):
    """_pair(make, n, k) for k = 0 .. batch-1, made on the host's cores at
    once (numpy's generator and BLAS release the GIL): the same pairs as
    made one after the other."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(lambda k: _pair(make, n, k), range(batch)))


def _kpoint_batch(torch, what, n=N_BATCHED, batch=K1_BATCH):
    """The k-point batch's operands on the card: ``batch`` distinct
    random_hpd_pair(n, seed=k), k = 0 .., as four fp64 planes."""
    import numpy as np


    t0 = time.perf_counter()
    pairs = _pairs("random_hpd_pair", n, batch)
    dev = lambda x: torch.tensor(np.stack(x), dtype=torch.float64, device="cuda")
    args = (dev([p[0].real for p in pairs]), dev([p[0].imag for p in pairs]),
            dev([p[1].real for p in pairs]), dev([p[1].imag for p in pairs]))
    log(f"{what}: {batch} x random_hpd_pair({n}, seed=k) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return args


def phase_batched_two_stage(torch):
    """The k-point batch (BASELINE config 4) with tridiag_mode='two': one
    batched solve of the 64 pairs of phase 10 (iu=128, mp) through psbrd
    (K6 a panel for the batch), the planar chase (K8 once) and the replay
    (K10 once), chunk None then 8: info, residual over every item, launches
    by the counters (K1 8, K6 31, K8 1, K10 1 a batched solve) and kineto,
    wall ms a batch and a problem, stage ms, busy ms, idle share, peak
    memory; items 0, 21, 42, 63 against their unbatched two-stage solves,
    whose mean wall ms times 64 is the item-by-item yardstick. Returns the
    batched kernels' launches and the wall ms of both routes."""
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar, zhegvdx_planar_batched
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel
    from eigensolver_gpu_torch.utils.timer import wall_ms

    batch, n, iu = K1_BATCH, N_BATCHED, IU_BATCHED
    cfg = SolverConfig(compute_dtype="float32", refine_iters=2, tridiag_mode="two")
    args = _kpoint_batch(torch, "main (batched, two-stage)")
    wrappers = (pchol_block_planar, ql_panel_planar, bulge_chase_planar_kernel,
                apply_q2_planar_kernel)
    want = {"pchol_block_planar": n // 128, "ql_panel_planar": n // BAND - 1,
            "bulge_chase_planar_kernel": 1, "apply_q2_planar_kernel": 1}
    for chunk in (None, 8):
        solve = lambda: zhegvdx_planar_batched(*args, il=1, iu=iu, cfg=cfg, chunk=chunk)
        for fn in wrappers:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res, first_ms = _timed_once(torch, solve)
        counts = {fn.__name__: fn.launches for fn in wrappers}
        peak = torch.cuda.max_memory_allocated() / 2**30
        info = res.info.cpu().tolist()
        resid = _device_residual(torch, args, res)
        finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.zr).all()
                      and torch.isfinite(res.zi).all())
        shapes = (tuple(res.w.shape), tuple(res.zr.shape), tuple(res.zi.shape),
                  tuple(res.info.shape))
        # the chunked solve is timed by its first call only (8 batched solves in turn)
        times = wall_ms(solve, iters=1) if chunk is None else [first_ms]
        log(f"main (batched, two-stage) chunk={chunk}: {batch} x n={n} iu={iu} mp "
            f"tridiag_mode=two: info all 0: {set(info) == {0}}, residual (max over items) "
            f"{resid:.3e}, first {first_ms:.1f} ms, timed {[round(x, 1) for x in times]} ms = "
            f"{min(times) / batch:.2f} ms a problem, launches K1={counts['pchol_block_planar']} "
            f"K6={counts['ql_panel_planar']} K8={counts['bulge_chase_planar_kernel']} "
            f"K10={counts['apply_q2_planar_kernel']}, peak memory {peak:.2f} GiB")
        if set(info) != {0} or not finite or not resid <= 1e-13:
            raise RuntimeError(f"batched two-stage path wrong: info={info} finite={finite} "
                               f"residual={resid}")
        if shapes != ((batch, iu), (batch, n, iu), (batch, n, iu), (batch,)):
            raise RuntimeError(f"batched two-stage path shapes {shapes}")
        chunks = 1 if chunk is None else batch // chunk
        if counts != {k: v * chunks for k, v in want.items()}:
            raise RuntimeError(f"launch counts {counts}, want {want} a (chunk of the) batch")
        if chunk is None:
            full, batched_ms = res, min(times)
            _, totals = _breakdown(torch, solve, batched_ms,
                                   kernels=("pchol_block_kernel", "ql_panel_planar_kernel",
                                            "chase_planar_kernel", "replay_planar_kernel"))
            _log_stedc("  stedc of the batched two-stage solve")
            seen = {k: totals[k][1] for k in ("ql_panel_planar_kernel", "chase_planar_kernel",
                                              "replay_planar_kernel")}
            if seen != {"ql_panel_planar_kernel": n // BAND - 1, "chase_planar_kernel": 1,
                        "replay_planar_kernel": 1}:
                raise RuntimeError(f"one batched two-stage solve ran {seen} kernels (kineto)")
        else:
            for k in range(batch):
                _held_items(torch, (res.w[k], torch.complex(res.zr[k], res.zi[k])),
                            (full.w[k], torch.complex(full.zr[k], full.zi[k])),
                            f"two-stage chunk=8 item {k}")
    del res

    item_ms = []
    for k in (0, batch // 3, 2 * batch // 3, batch - 1):  # 0, 21, 42, 63
        one = lambda: zhegvdx_planar(*(x[k] for x in args), il=1, iu=iu, cfg=cfg)
        single = one()
        item_ms += wall_ms(one, iters=1)
        werr, vdist = _held_items(torch, (full.w[k], torch.complex(full.zr[k], full.zi[k])),
                                  (single.w, torch.complex(single.zr, single.zi)),
                                  f"two-stage item {k}")
        log(f"  two-stage item {k} against its unbatched two-stage solve: eigenvalues "
            f"{werr:.2e} relative, vectors {vdist:.2e}, info {int(single.info)}, unbatched "
            f"{item_ms[-1]:.1f} ms")
    del full

    # the yardstick: the parent's route, the 64 problems one after the other,
    # estimated from the four timed ones (solving all 64 in turn took 32-34 s)
    turn_ms = sum(item_ms) / len(item_ms) * batch
    log(f"main (batched, two-stage) item by item, estimated: {batch} x the mean of the four "
        f"unbatched two-stage solves = {turn_ms:.1f} ms ({turn_ms / batched_ms:.2f}x the batched "
        "solve)")
    return {"launches": {k: v for k, v in want.items() if k != "pchol_block_planar"},
            "batched_two_stage_ms": batched_ms, "item_by_item_ms": turn_ms}


def _real_residual(torch, a, b, res):
    """bench.py's residual of a real problem or batch (leading axis), on the
    device: max_k ||A z_k - w_k B z_k|| / (n * max row 1-norm of A), the
    largest item's value."""
    n = a.shape[-1]
    r = a @ res.z - (b @ res.z) * res.w[..., None, :]
    anorm = torch.amax(torch.sum(a.abs(), dim=-1), dim=-1)
    return float(torch.max(torch.amax(torch.linalg.vector_norm(r, dim=-2), dim=-1)
                           / (n * anorm)))


def phase_batched_real_two_stage(torch):
    """The real k-point batch of phase 10 (sygvdx_batched on 64 x
    random_spd_pair(1024, seed=k), iu=64, mp) with tridiag_mode='two': one
    batched solve through sbrd (K5 a panel for the batch), the chase (K7
    once) and the replay (K9 once): info, residual over every item,
    launches by the counters (K5 31, K7 1, K9 1) and kineto, wall ms of the
    first and of a timed solve and ms a problem, stage ms, busy ms, idle
    share, peak memory; items 0, 21, 42, 63 against their unbatched
    two-stage solves, whose mean wall ms times 64 is the item-by-item
    yardstick. Returns the launches and both times."""
    import numpy as np

    from eigensolver_gpu_torch import SolverConfig, sygvdx, sygvdx_batched
    from eigensolver_gpu_torch.models.syevdx import takes_two_stage
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel
    from eigensolver_gpu_torch.utils.timer import wall_ms

    batch, n, iu = K1_BATCH, N_BATCHED, IU_BATCHED_REAL
    cfg = SolverConfig(compute_dtype="float32", refine_iters=2, tridiag_mode="two")
    if not takes_two_stage(n, torch.float64, cfg):
        raise RuntimeError("the real batched cell does not take the two-stage route")
    t0 = time.perf_counter()
    pairs = _pairs("random_spd_pair", n, batch)
    a = torch.tensor(np.stack([p[0] for p in pairs]), device="cuda")
    b = torch.tensor(np.stack([p[1] for p in pairs]), device="cuda")
    del pairs
    log(f"main (batched real, two-stage): {batch} x random_spd_pair({n}, seed=k) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    wrappers = (ql_panel, bulge_chase_kernel, apply_q2_kernel)
    want = {"ql_panel": n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
    solve = lambda: sygvdx_batched(a, b, il=1, iu=iu, cfg=cfg)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, first_ms = _timed_once(torch, solve)
    counts = {fn.__name__: fn.launches for fn in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2**30
    info = res.info.cpu().tolist()
    resid = _real_residual(torch, a, b, res)
    finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.z).all())
    shapes = (tuple(res.w.shape), tuple(res.z.shape), tuple(res.info.shape))
    times = wall_ms(solve, iters=1)
    batched_ms = min(times)
    log(f"main (batched real, two-stage): {batch} x n={n} iu={iu} mp tridiag_mode=two: info "
        f"all 0: {set(info) == {0}}, residual (max over items) {resid:.3e}, first "
        f"{first_ms:.1f} ms, timed {[round(x, 1) for x in times]} ms = "
        f"{batched_ms / batch:.2f} ms a problem, launches K5={counts['ql_panel']} "
        f"K7={counts['bulge_chase_kernel']} K9={counts['apply_q2_kernel']}, peak memory "
        f"{peak:.2f} GiB")
    if set(info) != {0} or not finite or not resid <= 1e-13:
        raise RuntimeError(f"batched real two-stage path wrong: info={info} finite={finite} "
                           f"residual={resid}")
    if shapes != ((batch, iu), (batch, n, iu), (batch,)):
        raise RuntimeError(f"batched real two-stage path shapes {shapes}")
    if counts != want:
        raise RuntimeError(f"launch counts {counts}, want {want} a batched solve")
    _, totals = _breakdown(torch, solve, batched_ms,
                           kernels=("ql_panel_kernel", "chase_kernel", "replay_kernel"))
    seen = {k: v[1] for k, v in totals.items()}
    if seen != {"ql_panel_kernel": n // BAND - 1, "chase_kernel": 1, "replay_kernel": 1}:
        raise RuntimeError(f"one batched real two-stage solve ran {seen} kernels (kineto)")
    item_ms = []
    for k in (0, batch // 3, 2 * batch // 3, batch - 1):  # 0, 21, 42, 63
        one = lambda: sygvdx(a[k], b[k], il=1, iu=iu, cfg=cfg)
        single = one()
        item_ms += wall_ms(one, iters=1)
        werr, vdist = _held_items(torch, (res.w[k], res.z[k]), (single.w, single.z),
                                  f"real two-stage item {k}")
        log(f"  real two-stage item {k} against its unbatched two-stage solve: eigenvalues "
            f"{werr:.2e} relative, vectors {vdist:.2e}, info {int(single.info)}, unbatched "
            f"{item_ms[-1]:.1f} ms")
    turn_ms = sum(item_ms) / len(item_ms) * batch
    log(f"main (batched real, two-stage) item by item, estimated: {batch} x the mean of the four "
        f"unbatched two-stage solves = {turn_ms:.1f} ms ({turn_ms / batched_ms:.2f}x the batched "
        "solve)")
    return {"launches": want, "batched_real_two_stage_ms": batched_ms,
            "real_item_by_item_ms": turn_ms}


def _pallas_batch(torch, what, solve, item_solve, pair, residual, want, keys):
    """One batched use_pallas=True solve of the k-point batch: info,
    residual over every item (``residual(res)``), the launches by the
    wrappers' counters (``want``: wrapper -> launches a batched solve) and
    by kineto (``keys``: kernel name key -> launches), wall ms of the first
    and of a timed solve, stage ms, busy ms, idle share and peak memory;
    items 0, 21, 42, 63 against their unbatched solves (``item_solve(k)``;
    ``pair(res, k)`` gives an item's (w, z)), whose mean wall ms times the
    batch is the item-by-item yardstick. Returns the readings."""
    from eigensolver_gpu_torch.utils.timer import wall_ms

    batch = K1_BATCH
    for fn in want:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, first_ms = _timed_once(torch, solve)
    counts = {fn.__name__: fn.launches for fn in want}
    peak = torch.cuda.max_memory_allocated() / 2**30
    info = res.info.cpu().tolist()
    resid = residual(res)
    finite = all(bool(torch.isfinite(x).all()) for x in res[:-1])
    times = wall_ms(solve, iters=1)
    batched_ms = min(times)
    log(f"{what}: info all 0: {set(info) == {0}}, residual (max over items) {resid:.3e}, first "
        f"{first_ms:.1f} ms, timed {[round(x, 1) for x in times]} ms = "
        f"{batched_ms / batch:.2f} ms a problem, launches {counts}, peak memory {peak:.2f} GiB")
    if len(info) != batch or set(info) != {0} or not finite or not resid <= 1e-13:
        raise RuntimeError(f"{what} wrong: info={info} finite={finite} residual={resid}")
    if counts != {fn.__name__: v for fn, v in want.items()}:
        raise RuntimeError(f"{what}: launch counts {counts}, want one batched solve's")
    stages, totals = _breakdown(torch, solve, batched_ms, kernels=tuple(keys))
    seen = {k: totals[k][1] for k in keys}
    if seen != keys:
        raise RuntimeError(f"{what}: one batched solve ran {seen} kernels (kineto), want {keys}")
    item_ms = []
    for k in (0, batch // 3, 2 * batch // 3, batch - 1):  # 0, 21, 42, 63
        # one solve an item, timed (the batched solves before it warmed the path)
        single, ms = _timed_once(torch, lambda: item_solve(k))
        item_ms.append(ms)
        werr, vdist = _held_items(torch, pair(res, k), pair(single, None), f"{what} item {k}")
        log(f"  item {k} against its unbatched use_pallas solve: eigenvalues {werr:.2e} "
            f"relative, vectors {vdist:.2e}, info {int(single.info)}, unbatched "
            f"{item_ms[-1]:.1f} ms")
    turn_ms = sum(item_ms) / len(item_ms) * batch
    log(f"{what} item by item, estimated: {batch} x the mean of the four unbatched solves = "
        f"{turn_ms:.1f} ms ({turn_ms / batched_ms:.2f}x the batched solve)")
    return {"launches": counts, "ms": batched_ms, "first_ms": first_ms,
            "item_by_item_ms": turn_ms, "residual": resid, "peak_gib": peak,
            "kernel_ms": {k: totals[k][0] for k in keys},
            "stages": {k: round(v, 1) for k, v in stages.items()}}


def phase_batched_pallas(torch):
    """The k-point batches of phase 10 with use_pallas=True, each as one
    batched solve (before the batch axes of K2 and K4 the batched entries
    solved such a batch item by item): zhegvdx_planar_batched on 64 x
    random_hpd_pair(1024, seed=k), iu=128, mp (K1 8 and K2 16 launches: the
    1024, 768, 512 and 256 buckets at bucket=128, four panels each), then
    sygvdx_batched on 64 x random_spd_pair(1024), iu=64, mp (K4 512: the
    1024 and 512 buckets at bucket=256, 16 panels of 32 columns), each with
    _pallas_batch's readings; then the first 8 planar pairs with
    use_pallas=True and tridiag_mode='two' as one batched solve (K6 31, K8
    1, K10 1, no K2). Returns the readings."""
    import numpy as np

    from eigensolver_gpu_torch import (
        SolverConfig,
        sygvdx,
        sygvdx_batched,
        zhegvdx_planar,
        zhegvdx_planar_batched,
    )
    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_planar_kernel
    from eigensolver_gpu_torch.ops.symv import symv

    batch, n = K1_BATCH, N_BATCHED
    cfg = SolverConfig(compute_dtype="float32", refine_iters=2, use_pallas=True)
    out = {}
    args = _kpoint_batch(torch, "main (batched, use_pallas)")
    planar_pair = lambda r, k: ((r.w, torch.complex(r.zr, r.zi)) if k is None
                                else (r.w[k], torch.complex(r.zr[k], r.zi[k])))
    out["planar"] = _pallas_batch(
        torch, f"main (batched, use_pallas) planar: {batch} x n={n} iu={IU_BATCHED} mp",
        lambda: zhegvdx_planar_batched(*args, il=1, iu=IU_BATCHED, cfg=cfg),
        lambda k: zhegvdx_planar(*(x[k] for x in args), il=1, iu=IU_BATCHED, cfg=cfg),
        planar_pair, lambda r: _device_residual(torch, args, r),
        {pchol_block_planar: n // 128, latrd_panel_planar: 16},
        {"pchol_block_kernel": n // 128, "latrd_": 16})

    # use_pallas with the two-stage reduction: K2 takes no part, and the
    # batch runs as one batched two-stage solve
    cfg_two = SolverConfig(compute_dtype="float32", refine_iters=2, use_pallas=True,
                           tridiag_mode="two")
    few = tuple(x[:8] for x in args)
    wrappers = (pchol_block_planar, latrd_panel_planar, ql_panel_planar,
                bulge_chase_planar_kernel, apply_q2_planar_kernel)
    for fn in wrappers:
        fn.launches = 0
    res, two_ms = _timed_once(
        torch, lambda: zhegvdx_planar_batched(*few, il=1, iu=IU_BATCHED, cfg=cfg_two))
    counts = {fn.__name__: fn.launches for fn in wrappers}
    resid = _device_residual(torch, few, res)
    info = res.info.cpu().tolist()
    log(f"main (batched, use_pallas) planar two-stage: 8 x n={n} iu={IU_BATCHED} mp, one batched "
        f"solve {two_ms:.1f} ms (first call), info {info}, residual {resid:.3e}, launches {counts}")
    want = {"pchol_block_planar": n // 128, "latrd_panel_planar": 0,
            "ql_panel_planar": n // BAND - 1, "bulge_chase_planar_kernel": 1,
            "apply_q2_planar_kernel": 1}
    if set(info) != {0} or not resid <= 1e-13 or counts != want:
        raise RuntimeError(f"batched use_pallas two-stage solve: info {info}, residual {resid}, "
                           f"launches {counts}, want {want}")
    out["planar_two_stage_8_ms"] = two_ms
    del args, few, res

    t0 = time.perf_counter()
    pairs = _pairs("random_spd_pair", n, batch)
    a = torch.tensor(np.stack([p[0] for p in pairs]), device="cuda")
    b = torch.tensor(np.stack([p[1] for p in pairs]), device="cuda")
    del pairs
    log(f"main (batched, use_pallas) real: {batch} x random_spd_pair({n}, seed=k) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    real_pair = lambda r, k: (r.w, r.z) if k is None else (r.w[k], r.z[k])
    out["real"] = _pallas_batch(
        torch, f"main (batched, use_pallas) real: {batch} x n={n} iu={IU_BATCHED_REAL} mp",
        lambda: sygvdx_batched(a, b, il=1, iu=IU_BATCHED_REAL, cfg=cfg),
        lambda k: sygvdx(a[k], b[k], il=1, iu=IU_BATCHED_REAL, cfg=cfg),
        real_pair, lambda r: _real_residual(torch, a, b, r),
        {symv: (n // 512) * (256 // 32) * 32}, {"symv_kernel": (n // 512) * (256 // 32) * 32})
    return out


def _embedded_readings(torch, what, solve, args, want, wrappers):
    """One embedded solve on ``args`` (fp64 planes, a batch or not) with
    synchronizing ranges, then one under the profiler: info, the device
    residual of the complex pairs, the launches of the three real two-stage
    kernels (``want``), peak memory, wall and stage ms (the extraction's on
    its own line), busy ms and idle share. The wall is that of the
    synchronized solve: its ranges add a synchronization at each of about
    a dozen stage boundaries of a 5-14 s solve, and the first solve of the
    process has come within 1-14 % of a later unsynchronized one on the
    card (its one-time set-up hides in the host-paced Jacobi rounds).
    Returns the result and the wall ms."""
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, stages, first_ms = _synced(torch, solve)
    counts = {fn.__name__: fn.launches for fn in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2**30
    info = res.info.reshape(-1).cpu().tolist()
    resid = _device_residual(torch, args, res)
    finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.zr).all()
                  and torch.isfinite(res.zi).all())
    lead = args[0].shape[:-2]
    per = f" = {first_ms / lead[0]:.2f} ms a problem" if lead else ""
    log(f"{what}: info all 0: {set(info) == {0}}, residual (complex pairs, max over items) "
        f"{resid:.3e}, one solve (the first, with synchronizing ranges) {first_ms:.1f} ms{per}, "
        f"launches K5={counts['ql_panel']} K7={counts['bulge_chase_kernel']} "
        f"K9={counts['apply_q2_kernel']}, peak memory {peak:.2f} GiB")
    if set(info) != {0} or not finite or not resid <= 1e-13:
        raise RuntimeError(f"{what} wrong: info={info} finite={finite} residual={resid}")
    if counts != want:
        raise RuntimeError(f"{what}: launch counts {counts}, want {want}")
    stages, totals = _breakdown(torch, solve, first_ms, stages=stages,
                                kernels=("ql_panel_kernel", "chase_kernel", "replay_kernel"))
    log(f"  the extraction (extract_invariant: compression, Cholesky-QR, Rayleigh-Ritz with "
        f"jacobi_eigh_planar), synchronized: {stages.get('extract_invariant', 0.0):.1f} ms")
    seen = {k: v[1] for k, v in totals.items()}
    if seen != {"ql_panel_kernel": want["ql_panel"], "chase_kernel": 1, "replay_kernel": 1}:
        raise RuntimeError(f"{what}: one solve ran {seen} kernels (kineto)")
    return res, first_ms


def phase_embedded(torch):
    """The complex solve through the real embedding at full width: the main
    problem random_hpd_pair(4096, seed=0), iu=1024, fp64, as a real 8192
    problem ('auto' takes the two-stage route: K5 255, K7 1, K9 1); then
    zhegvdx_embedded_batched on 8 x random_hpd_pair(2048, seed=k), iu=256,
    fp64 (8 x 4096 real, one batched two-stage solve: K5 127, K7 1, K9 1),
    items 0 and 7 against their unbatched embedded solves. Returns the
    wall ms of both."""
    from eigensolver_gpu_torch import SolverConfig
    from eigensolver_gpu_torch.models.syevdx import takes_two_stage
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.complex_embed import (
        zhegvdx_embedded,
        zhegvdx_embedded_batched,
    )
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel

    cfg = SolverConfig()
    wrappers = (ql_panel, bulge_chase_kernel, apply_q2_kernel)
    if not takes_two_stage(2 * N_EMBED_BATCHED, torch.float64, cfg):
        raise RuntimeError("fp64 'auto' does not take the two-stage route at the embedded sizes")
    args = _main_args(torch)
    want = {"ql_panel": 2 * N_MAIN // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
    res, main_ms = _embedded_readings(
        torch, f"main (embedded): zhegvdx_embedded n={N_MAIN} (real {2 * N_MAIN}) iu={IU_MAIN} "
        "fp64", lambda: zhegvdx_embedded(*args, il=1, iu=IU_MAIN, cfg=cfg), args, want, wrappers)
    if tuple(res.zr.shape) != (N_MAIN, IU_MAIN) or tuple(res.w.shape) != (IU_MAIN,):
        raise RuntimeError(f"embedded main shapes {tuple(res.w.shape)}, {tuple(res.zr.shape)}")
    del args, res

    batch, n, iu = EMBED_BATCH, N_EMBED_BATCHED, IU_EMBED_BATCHED
    args = _kpoint_batch(torch, "main (embedded, batched)", n=n, batch=batch)
    want = {"ql_panel": 2 * n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
    res, batched_ms = _embedded_readings(
        torch, f"main (embedded, batched): zhegvdx_embedded_batched {batch} x n={n} (real "
        f"{2 * n}) iu={iu} fp64", lambda: zhegvdx_embedded_batched(*args, il=1, iu=iu, cfg=cfg),
        args, want, wrappers)
    if tuple(res.zr.shape) != (batch, n, iu) or tuple(res.info.shape) != (batch,):
        raise RuntimeError(f"embedded batch shapes {tuple(res.zr.shape)}, "
                           f"{tuple(res.info.shape)}")
    for k in (0, batch - 1):
        single = zhegvdx_embedded(*(x[k] for x in args), il=1, iu=iu, cfg=cfg)
        werr, vdist = _held_items(torch, (res.w[k], torch.complex(res.zr[k], res.zi[k])),
                                  (single.w, torch.complex(single.zr, single.zi)),
                                  f"embedded item {k}")
        log(f"  embedded item {k} against its unbatched embedded solve: eigenvalues {werr:.2e} "
            f"relative, vectors {vdist:.2e}, info {int(single.info)}")
    return {"embedded_ms": main_ms, "embedded_batched_ms": batched_ms}


def phase_reference_embedded(torch):
    """zhegvdx_via_embedding at n=1024, iu=256, fp64 against
    scipy.linalg.eigh (eigenvalues within 1e-10 n, ge_residual < 1e-12),
    then on the exactly degenerate spectrum of the JAX package's
    tests/test_complex_embed.py scaled to n=1024 (a 96-fold and a 64-fold
    cluster inside il=1..iu=512, B = I): eigenvalues within 1e-10 n, the
    vectors B-orthonormal to 1e-9 n and of full rank. Its ge_residual is
    logged beside the 1e-12 of the JAX test at n = 64: the extraction's
    Jacobi runs JAX's 12 sweeps, which do not converge at m = 512 on this
    spectrum (2.0e-10 on the card; ROADMAP.md C, a limit shared with the
    reference)."""
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch.ops.complex_embed import zhegvdx_via_embedding
    from eigensolver_gpu_torch.utils.testing import ge_residual, orthonormality_error

    n, iu = N_REF, IU_REF
    a, b = _pair("random_hpd_pair", n, 1)
    w_ref = scipy.linalg.eigh(a, b, eigvals_only=True, subset_by_index=[0, iu - 1])
    res = zhegvdx_via_embedding(a, b, il=1, iu=iu, device="cuda")
    w = res.w.cpu().numpy()
    z = res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
    err = float(np.abs(w - w_ref).max())
    resid = ge_residual(a, b, w, z)
    log(f"reference embedded n={n} iu={iu} fp64: max |w - scipy| = {err:.3e} (tol "
        f"{1e-10 * n:.1e}), ge_residual = {resid:.3e}, info={int(res.info)}")
    if not err <= 1e-10 * n or int(res.info) != 0 or not resid < 1e-12:
        raise RuntimeError("embedded reference comparison failed")
    rng = np.random.default_rng(72)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(t)
    w0 = np.sort(rng.standard_normal(n))
    w0[48:144] = w0[48]  # JAX's clusters [3:9) and [20:24) at n = 64, scaled by 16
    w0[320:384] = w0[320]
    a = (q * w0[None, :]) @ q.conj().T
    a = (a + a.conj().T) / 2
    b = np.eye(n, dtype=complex)
    m = 512
    res = zhegvdx_via_embedding(a, b, il=1, iu=m, device="cuda")
    w = res.w.cpu().numpy()
    z = res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
    err = float(np.abs(w - w0[:m]).max())
    orth = orthonormality_error(z, b)
    rank = int(np.linalg.matrix_rank(z, tol=1e-6))
    resid = ge_residual(a, b, w, z)
    log(f"reference embedded, exactly degenerate (96- and 64-fold clusters) n={n} iu={m} fp64: "
        f"max |w - w0| = {err:.3e}, B-orthonormality {orth:.3e} (tol {1e-9 * n:.1e}), rank "
        f"{rank}, info={int(res.info)}; ge_residual = {resid:.3e} (the JAX test's bar at n = 64: "
        "1e-12; not held here, see the docstring)")
    if not err <= 1e-10 * n or not orth < 1e-9 * n or rank != m or not math.isfinite(resid) \
            or int(res.info) != 0:
        raise RuntimeError("embedded reference on the degenerate spectrum failed")


def _log_stedc(what):
    """stedc's secular sweeps a merge and its compact merges (n2, alive
    counts, buckets; a batch summarized) of its last call."""
    from eigensolver_gpu_torch.ops.stedc import stedc

    compact = []
    for n2, alive, bucket in stedc.compact:
        if len(alive) == 1:
            compact.append(f"n2={n2} alive={alive[0]} bucket={bucket[0]}")
        else:
            counts = {b: bucket.count(b) for b in sorted(set(bucket))}
            compact.append(f"n2={n2} alive {min(alive)}..{max(alive)} over {len(alive)} items, "
                           f"buckets {counts}")
    log(f"{what}: secular sweeps a merge {stedc.sweeps}; compact merges: {'; '.join(compact)}")


def _main_args(torch):
    """random_hpd_pair(N_MAIN, seed=0) as fp64 planes on the card."""
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy

    return planar_from_numpy(*_pair("random_hpd_pair", N_MAIN, 0), device="cuda",
                             dtype=torch.float64)


def _check_main(torch, args, res, what):
    """info 0, finite outputs of the main shapes, residual <= 1e-13."""
    resid = _device_residual(torch, args, res)
    finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.zr).all()
                  and torch.isfinite(res.zi).all())
    shapes = (tuple(res.w.shape), tuple(res.zr.shape), tuple(res.zi.shape))
    if int(res.info) != 0 or not finite or not resid <= 1e-13:
        raise RuntimeError(f"{what} wrong: info={int(res.info)} finite={finite} residual={resid}")
    if shapes != ((IU_MAIN,), (N_MAIN, IU_MAIN), (N_MAIN, IU_MAIN)):
        raise RuntimeError(f"{what} shapes {shapes}")
    return resid


def phase_trinv(torch, args):
    """The main problem with planar_solve_mode 'trinv' beside 'blockinv'
    with tridiag_mode='two' (a first and a timed solve each), and 'trinv' on
    the one-stage default path (a first solve): residual, info, K1 launches
    (32: the Cholesky's block steps), peak memory; then the Cholesky, the three block-inverted solves
    and ptrinv_lower with its three planar gemms, each timed alone on the
    fp32 planes at the solve's shapes (all n x n: the inner solve is
    full-spectrum)."""
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.planar import (
        pcholesky_lower,
        pH,
        pmatmul,
        ptrinv_lower,
        ptrsm_left_lower_inv,
        ptrsm_left_upper,
    )
    from eigensolver_gpu_torch.utils.timer import wall_ms

    log(f"trinv phase on {_smi()}")
    # the one-stage solve (10 s on the card) runs 'trinv' once: its 'blockinv'
    # twin is phase 4's solve, and the solves differ only outside the reduction
    for tridiag, mode in (("auto", "trinv"), ("two", "blockinv"), ("two", "trinv")):
        cfg = SolverConfig(compute_dtype="float32", planar_solve_mode=mode,
                           tridiag_mode=tridiag)
        solve = lambda: zhegvdx_planar(*args, il=1, iu=IU_MAIN, cfg=cfg)
        pchol_block_planar.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res, first_ms = _timed_once(torch, solve)
        k1 = pchol_block_planar.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        resid = _check_main(torch, args, res, f"{mode} tridiag_mode={tridiag}")
        times = wall_ms(solve, iters=1) if tridiag == "two" else []
        log(f"trinv phase: planar_solve_mode={mode} tridiag_mode={tridiag}: n={N_MAIN} "
            f"iu={IU_MAIN} info=0 residual={resid:.3e} first={first_ms:.1f} ms "
            f"timed={[round(x, 1) for x in times]} ms K1 launches={k1} peak_mem={peak:.2f} GiB")
        if k1 != N_MAIN // 128:
            raise RuntimeError(f"{mode}: K1 launched {k1} times, want {N_MAIN // 128}")
        del res
    # the stages alone, on the fp32 planes of the inner solve
    a32 = tuple(x.float() for x in args[:2])
    b32 = tuple(x.float() for x in args[2:])
    nb = 128
    t_chol = min(wall_ms(lambda: pcholesky_lower(b32, nb=nb), iters=2))
    l, _ = pcholesky_lower(b32, nb=nb)

    def blockinv():
        x = ptrsm_left_lower_inv(l, a32, nb=nb)
        y = ptrsm_left_lower_inv(l, pH(x), nb=nb)
        return ptrsm_left_upper(pH(l), y, nb=nb, solve_lower=ptrsm_left_lower_inv)

    def trinv():
        linv = ptrinv_lower(l)
        x = pmatmul(linv, a32)
        y = pmatmul(linv, pH(x))
        return pmatmul(pH(linv), y)

    t_block = min(wall_ms(blockinv, iters=2))
    t_inv = min(wall_ms(lambda: ptrinv_lower(l), iters=2))
    t_trinv = min(wall_ms(trinv, iters=2))
    got, want = trinv(), blockinv()
    rel = max(float((g - w).abs().max()) for g, w in zip(got, want)) / float(
        max(w.abs().max() for w in want))
    log(f"  alone at n={N_MAIN} (fp32 planes, ms, synchronized): pcholesky_lower {t_chol:.1f}; "
        f"blockinv: three solves {t_block:.1f}; trinv: ptrinv_lower {t_inv:.1f}, with its three "
        f"planar gemms {t_trinv:.1f}; the two routes' phase-4 outputs differ by {rel:.2e} "
        f"(relative; eps32 * kappa)")
    if not rel < 1e-2:
        raise RuntimeError(f"trinv and blockinv solves disagree: {rel}")


def _merge_residual(torch, margs, w, q):
    """max |M q - q diag(w)| / max |w| in fp64, M the matrix the merge
    diagonalizes: blockdiag(Q1 D1 Q1^T, Q2 D2 Q2^T) + |beta| v v^T."""
    d1, q1, d2, q2, beta = (x[0].double() for x in margs[:5])
    m = d1.shape[0]
    n2 = m + d2.shape[0]
    t = torch.zeros((n2, n2), dtype=torch.float64, device=d1.device)
    t[:m, :m] = (q1 * d1) @ q1.T
    t[m:, m:] = (q2 * d2) @ q2.T
    v = torch.zeros(n2, dtype=torch.float64, device=d1.device)
    v[m - 1], v[m] = torch.sign(beta), 1.0
    t += beta.abs() * torch.outer(v, v)
    w, q = w[0].double(), q[0].double()
    return float((t @ q - q * w).abs().max() / w.abs().max())


def phase_stedc(torch, args):
    """For the tridiagonals of the planar two-stage mp solves of
    random_hpd_pair(4096) and qe_style_pair(4096): the solve (residual,
    info), stedc's sweeps and compact merges, stedc alone for each
    STOP_EVERY, and the n2=4096 top merge with compact=False beside
    compact=True: eigenvalues within MERGE_W_TOL relative, both merge
    residuals below 1e-4 and within 10x of each other."""
    import eigensolver_gpu_torch.models.zhegvdx_planar as model
    import eigensolver_gpu_torch.ops.stedc as stedc_mod
    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy
    from eigensolver_gpu_torch.utils.timer import wall_ms

    log(f"stedc phase on {_smi()}")
    cfg = SolverConfig(compute_dtype="float32", tridiag_mode="two")
    real_stedc, real_merge = model.stedc, stedc_mod._merge_pair
    stop_every = stedc_mod.STOP_EVERY
    for name in ("random_hpd_pair", "qe_style_pair"):
        if name == "qe_style_pair":
            t0 = time.perf_counter()
            args = planar_from_numpy(*_pair("qe_style_pair", N_MAIN, 0), device="cuda",
                                     dtype=torch.float64)
            log(f"stedc phase: qe_style_pair({N_MAIN}, seed=0) on the card in "
                f"{time.perf_counter() - t0:.1f} s")
        caught = {}

        def stedc_rec(d, e, **kw):
            caught["tridiag"] = (d.clone(), e.clone(), kw)
            return real_stedc(d, e, **kw)

        def merge_rec(*margs, **kw):
            if margs[0].shape[1] + margs[2].shape[1] == N_MAIN:
                caught["merge"] = tuple(x.clone() for x in margs)
            return real_merge(*margs, **kw)

        model.stedc, stedc_mod._merge_pair = stedc_rec, merge_rec
        try:
            res, first_ms = _timed_once(
                torch, lambda: zhegvdx_planar(*args, il=1, iu=IU_MAIN, cfg=cfg))
        finally:
            model.stedc, stedc_mod._merge_pair = real_stedc, real_merge
        resid = _check_main(torch, args, res, f"planar two-stage solve of {name}")
        log(f"stedc phase, {name}: planar two-stage mp solve info=0 residual={resid:.3e} "
            f"one solve {first_ms:.1f} ms")
        _log_stedc("  stedc of that solve")
        d, e, kw = caught["tridiag"]
        by_k = []
        try:
            for k in STOP_EVERY_TIMED:
                stedc_mod.STOP_EVERY = k
                by_k.append((k, min(wall_ms(lambda: real_stedc(d, e, **kw), iters=2)),
                             sum(real_stedc.sweeps)))
        finally:
            stedc_mod.STOP_EVERY = stop_every
        log("  stedc alone (ms, synchronized; sweeps over all merges) by STOP_EVERY: "
            + ", ".join(f"{k}: {ms:.1f} ({sw})" for k, ms, sw in by_k))
        margs = caught["merge"]
        out = {}
        for compact in (False, True):
            fn = lambda: real_merge(*margs, compact=compact)
            w, q = fn()
            out[compact] = (min(wall_ms(fn, iters=2)), w, q, _merge_residual(torch, margs, w, q))
        (t0_, w0, _, r0), (t1_, w1, _, r1) = out[False], out[True]
        werr = float((w1 - w0).abs().max() / w0.abs().max())
        log(f"  top merge n2={N_MAIN}: compact=False {t0_:.1f} ms residual {r0:.2e}; "
            f"compact=True {t1_:.1f} ms residual {r1:.2e} (alive {real_merge.alive}, bucket "
            f"{real_merge.bucket}); eigenvalues {werr:.2e} apart (relative)")
        if not werr <= MERGE_W_TOL or not max(r0, r1) < 1e-4 or max(r0, r1) > 10 * min(r0, r1):
            raise RuntimeError(f"{name}: compact and full assembly disagree: w {werr}, "
                               f"residuals {r0} and {r1}")
        del res, caught, out


def phase_ozaki(torch, args):
    """refine_gevp_planar called as the mixed driver calls it at the main
    path's shapes (fp64 A and B, the fp32 pipeline's full basis from a
    two-stage inner solve, sel=(0, 1056), w0, extra_max=2, two sweeps),
    with gemm 'native' beside 'ozaki': ms (first and timed) and the
    residual of the il..iu block (<= 1e-13); then one ozaki_matmul of A's
    real plane (4096 x 4096) by the basis block (4096 x 1056) against the
    fp64 product: error below OZAKI_ERR times (|A| |B|)_ij, logged also in
    units of rowmax * colmax."""
    from types import SimpleNamespace

    from eigensolver_gpu_torch import SolverConfig, zhegvdx_planar
    from eigensolver_gpu_torch.ops.ozaki import ozaki_matmul
    from eigensolver_gpu_torch.ops.planar import pmatmul
    from eigensolver_gpu_torch.ops.refine_planar import refine_gevp_planar
    from eigensolver_gpu_torch.utils.timer import wall_ms

    log(f"ozaki phase on {_smi()}")
    ar, ai, br, bi = args
    cfg = SolverConfig(tridiag_mode="two")
    w32, zr32, zi32, info = zhegvdx_planar(*(x.float() for x in args), il=1, iu=N_MAIN, cfg=cfg)
    if int(info) != 0:
        raise RuntimeError(f"the fp32 inner solve failed: info {int(info)}")
    x64 = (zr32.double(), zi32.double())
    w0 = w32.double()
    base = SolverConfig()
    timed = {}
    for gemm, final_pass in (("native", False), ("ozaki", False), ("native", True)):
        fn = lambda: refine_gevp_planar((ar, ai), (br, bi), x64, sweeps=base.refine_iters,
                                        final_pass=final_pass, sel=SEL_MAIN, w0=w0,
                                        extra_max=base.refine_extra_max, gemm=gemm)
        (w, (zr, zi)), first_ms = _timed_once(torch, fn)
        what = f"refine_gevp_planar gemm={gemm} final_pass={final_pass}"
        if final_pass:  # every column of the block at B-norm 1
            bxr, bxi = pmatmul((br, bi), (zr, zi))
            bnorm_err = float((torch.sum(zr * bxr + zi * bxi, dim=0) - 1.0).abs().max())
            if not bnorm_err <= FINAL_PASS_BNORM_TOL:
                raise RuntimeError(f"{what}: B-norms {bnorm_err:.3e} from 1")
        order = torch.argsort(w)[:IU_MAIN]
        res = SimpleNamespace(w=w[order], zr=zr[:, order], zi=zi[:, order], info=info)
        resid = _check_main(torch, args, res, what)
        times = wall_ms(fn, iters=1)
        timed[gemm, final_pass] = min(times)
        log(f"ozaki phase: {what} sel={SEL_MAIN}: residual {resid:.3e} first {first_ms:.1f} ms "
            f"timed {[round(x, 1) for x in times]} ms"
            + (f", B-norms within {bnorm_err:.2e} of 1" if final_pass else ""))
    log(f"ozaki phase: final_pass=True (native) {timed['native', True]:.1f} ms beside "
        f"final_pass=False {timed['native', False]:.1f} ms: "
        f"{timed['native', True] - timed['native', False]:+.1f} ms")
    a = ar
    bmat = x64[0][:, : SEL_MAIN[1]].contiguous()
    got = ozaki_matmul(a, bmat)
    ms = min(wall_ms(lambda: ozaki_matmul(a, bmat), iters=2))
    ref = a @ bmat
    err = (got - ref).abs()
    rel_ab = float((err / (a.abs() @ bmat.abs())).max())
    rel_rc = float((err / (a.abs().amax(1, keepdim=True) * bmat.abs().amax(0, keepdim=True))).max())
    log(f"  ozaki_matmul ({N_MAIN}, {N_MAIN}) x ({N_MAIN}, {SEL_MAIN[1]}): {ms:.1f} ms; error "
        f"2^{math.log2(rel_ab):.2f} of (|A| |B|)_ij (bound 2^{math.log2(OZAKI_ERR):.0f}), "
        f"2^{math.log2(rel_rc):.2f} of rowmax * colmax")
    if not rel_ab < OZAKI_ERR:
        raise RuntimeError(f"ozaki_matmul error {rel_ab} above {OZAKI_ERR} of |A| |B|")
    del got, ref, err
    _roofline_rows(torch, a, bmat)


def _roofline_rows(torch, a, bmat):
    """utils/roofline.py's rows, each timed by CUDA events (device_ms): the
    ozaki product above (prec 'ozaki', effective fp64 operations) and the
    same product by torch.matmul in fp64, then torch.matmul at 8192^2 in
    fp32 (TF32 off), bf16 and fp64, and one 2 GiB device copy (bytes read
    plus written). Fails if any share reads above ROOF_MAX_PCT: a wrong
    ceiling or count."""
    from eigensolver_gpu_torch.ops.ozaki import ozaki_matmul
    from eigensolver_gpu_torch.utils.precision import true_fp32
    from eigensolver_gpu_torch.utils.roofline import format_row, stage_roofline
    from eigensolver_gpu_torch.utils.timer import device_ms

    n, k = a.shape
    m = bmat.shape[1]
    rows = [("ozaki_matmul", lambda: ozaki_matmul(a, bmat), 2.0 * n * k * m, "ozaki",
             8.0 * (n * k + k * m + n * m), 3),
            ("matmul f64", lambda: a @ bmat, 2.0 * n * k * m, "f64",
             8.0 * (n * k + k * m + n * m), 5)]
    big = ROOF_N
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("f64", torch.float64)):
        x = torch.randn(big, big, device="cuda").to(dt)
        y = torch.randn(big, big, device="cuda").to(dt)
        size = x.element_size()
        rows.append((f"matmul {prec} {big}", lambda x=x, y=y: x @ y, 2.0 * big**3, prec,
                     3.0 * size * big * big, 5))
    src = torch.empty(ROOF_COPY_BYTES, dtype=torch.uint8, device="cuda").random_(0, 255)
    dst = torch.empty_like(src)
    rows.append(("copy 2 GiB", lambda: dst.copy_(src), 0.0, "f32", 2.0 * ROOF_COPY_BYTES, 5))
    log(f"roofline (utils/roofline.py, the H100's published ceilings) on {_smi()}:")
    worst = 0.0
    with true_fp32():
        for name, fn, flops, prec, nbytes, iters in rows:
            ms = device_ms(fn, iters=iters, warmup=1)
            compute, hbm, _ = stage_roofline(ms, flops, prec, nbytes)
            worst = max(worst, compute, hbm)
            log(format_row(name, ms, flops, prec, nbytes) + f"  ({ms:.4f} ms)")
    if worst > ROOF_MAX_PCT:
        raise RuntimeError(f"a roofline share reads {worst:.1f} % (> {ROOF_MAX_PCT} %): "
                           "a wrong ceiling or operation count")


def phase_reference_real(torch):
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.utils.testing import ge_residual

    n, iu = N_REF_REAL, IU_REF_REAL
    a, b = _pair("random_spd_pair", n, 1)
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


N_TP, IU_TP = 16384, 2048  # BASELINE config 5: the tensor-parallel cell
SHARED_W = "tp_one_rank_w4096.npy"  # phase 17's n = 4096 eigenvalues, read by phase 18


def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spd_draws(n, seed):
    """The two normal draws of random_spd_pair(n, seed) (numpy's generator,
    the same stream), on the host."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)), rng.standard_normal((n, n))


def _spd_on_card(torch, n, seed, draws=None):
    """random_spd_pair(n, seed) with its products formed on the card in fp64
    (the same draws; B's rounding may differ from the host's product in the
    last bit): a, b on the card."""
    t, t2 = draws if draws is not None else _spd_draws(n, seed)
    t = torch.from_numpy(t).cuda()
    a = (t + t.T) / 2
    del t
    t2 = torch.from_numpy(t2).cuda()
    b = t2 @ t2.T / n + torch.eye(n, dtype=torch.float64, device="cuda")
    return a, b


def _draw_batch(make, n, batch):
    """The normal draws of ``batch`` pairs of utils.testing's fixture ``make``
    at seeds 0 .. batch-1, drawn on the host's cores at once."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    def one(k):
        rng = np.random.default_rng(k)
        if make == "random_spd_pair":
            return rng.standard_normal((n, n)), rng.standard_normal((n, n))
        t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return t, rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))

    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(one, range(batch)))


def _batch_on_card(torch, make, n, batch):
    """``batch`` pairs of ``make`` (random_spd_pair or random_hpd_pair) at
    seeds 0 .. batch-1 with their products formed on the card: (a, b) real,
    or the four fp64 planes (ar, ai, br, bi) of the complex pairs."""
    import numpy as np

    draws = _draw_batch(make, n, batch)
    t = torch.from_numpy(np.stack([d[0] for d in draws])).cuda()
    a = (t + t.mH) / 2
    t = torch.from_numpy(np.stack([d[1] for d in draws])).cuda()
    del draws
    b = t @ t.mH / n + torch.eye(n, dtype=t.dtype, device="cuda")
    del t
    if make == "random_spd_pair":
        return a, b
    return tuple(x.contiguous() for x in (a.real, a.imag, b.real, b.imag))


def _real_check(torch, res, a, b, n, iu, what):
    """info 0, finite outputs of the right shapes and dtype, residual <= 1e-13;
    returns the residual."""
    resid = _real_residual(torch, a, b, res)
    finite = bool(torch.isfinite(res.w).all() and torch.isfinite(res.z).all())
    shapes = (tuple(res.w.shape), tuple(res.z.shape), res.w.dtype, res.info.dtype)
    if int(res.info) != 0 or not finite or not resid <= 1e-13:
        raise RuntimeError(f"{what} wrong: info={int(res.info)} finite={finite} residual={resid}")
    if shapes != ((iu,), (n, iu), torch.float64, torch.int32):
        raise RuntimeError(f"{what} shapes and dtypes {shapes}")
    return resid


def phase_sharded_tp(torch):
    """Phase 17: sygvdx_sharded over make_mesh(1), a world of one NCCL rank
    (this process, a fresh TCP store), at full width: BASELINE config 5,
    random_spd_pair(16384, seed=0) (products formed on the card), il=1,
    iu=2048, mp, tridiag_mode='two'. One solve with synchronizing ranges:
    info, residual, wall ms, stage ms, peak memory, the launches of K5, K7,
    K9 (counters zeroed just before it, read just after) and the
    collectives by name and stage. Then config 2 (n=4096, iu=512, mp,
    two-stage) sharded beside the unsharded dsygvdx: eigenvalues within
    1e-12 relative; its eigenvalues are kept for phase 18."""
    import numpy as np
    import torch.distributed as dist

    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel
    from eigensolver_gpu_torch.parallel import comm, make_mesh, sygvdx_sharded

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        cfg = SolverConfig(compute_dtype="float32", tridiag_mode="two")
        n, iu = N_TP, IU_TP
        t0 = time.perf_counter()
        a, b = _spd_on_card(torch, n, 0, _pair("draws", n, 0))
        log(f"sharded (tp, one rank): random_spd_pair({n}, seed=0) on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        wrappers = (ql_panel, bulge_chase_kernel, apply_q2_kernel)
        for fn in wrappers:
            fn.launches = 0
        comm.reset()
        torch.cuda.reset_peak_memory_stats()
        res, stages, ms = _synced(torch, lambda: sygvdx_sharded(a, b, mesh, il=1, iu=iu, cfg=cfg))
        counts = {fn.__name__: fn.launches for fn in wrappers}
        calls, by_stage = dict(comm.calls), dict(comm.stages)
        peak = torch.cuda.max_memory_allocated() / 2**30
        resid5 = _real_check(torch, res, a, b, n, iu, "sharded tp config 5")
        log(f"sharded (tp, one rank): sygvdx_sharded n={n} iu={iu} mp two-stage make_mesh(1) "
            f"(NCCL): info=0 residual={resid5:.3e} wall {ms:.1f} ms (one solve, synchronizing "
            f"ranges, no warm-up) launches K5={counts['ql_panel']} "
            f"K7={counts['bulge_chase_kernel']} K9={counts['apply_q2_kernel']} peak memory "
            f"{peak:.2f} GiB")
        log("  stages (ms, synchronized): " + " ".join(f"{k}={v:.1f}" for k, v in stages.items()))
        log(f"  collectives by name {calls}, by stage {by_stage}")
        want = {"ql_panel": n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}
        if counts != want:
            raise RuntimeError(f"launch counts {counts}, want {want}")
        del a, b, res
        torch.cuda.empty_cache()

        n, iu = N_REAL, IU_REAL
        a, b = _spd_on_card(torch, n, 0, _pair("draws", n, 0))
        sh, sh_ms = _timed_once(torch, lambda: sygvdx_sharded(a, b, mesh, il=1, iu=iu, cfg=cfg))
        un, un_ms = _timed_once(torch, lambda: dsygvdx(a, b, il=1, iu=iu, cfg=cfg))
        resid = _real_check(torch, sh, a, b, n, iu, "sharded tp config 2")
        werr = float((sh.w - un.w).abs().max() / un.w.abs().max())
        log(f"sharded (tp, one rank): n={n} iu={iu} mp two-stage: info=0 residual={resid:.3e}, "
            f"{sh_ms:.1f} ms (first call) beside the unsharded dsygvdx {un_ms:.1f} ms; "
            f"eigenvalues {werr:.2e} relative from it")
        if not werr <= 1e-12:
            raise RuntimeError(f"sharded n={n} eigenvalues {werr:.3e} from the unsharded solve")
        np.save(os.path.join(os.environ["CHIP_SMOKE_TMP"], SHARED_W), sh.w.cpu().numpy())
        return {"tp": {"launches": want, "ms": ms, "residual": resid5, "peak_gib": peak,
                       "collectives": calls}}
    finally:
        dist.destroy_process_group()


def _nccl_probe_rank(rank, port):
    """One rank of a two-rank NCCL world on card 0: one all_reduce."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def _nccl_two_ranks_one_card():
    """What NCCL does with two ranks on one card: the line of the error it
    raised (expected: "Duplicate GPU detected"), or what else happened.
    The ranks are killed after 120 s."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_nccl_probe_rank, args=(_free_port(),), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.time() + 120
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                return "no answer in 120 s (ranks killed)"
    except Exception as exc:  # noqa: BLE001 -- the refusal is the reading
        lines = [ln.strip() for ln in str(exc).splitlines() if ln.strip()]
        hits = [ln for ln in lines if "Duplicate GPU" in ln] or lines[-1:]
        return f"refused: {hits[0][:300]}" if hits else f"refused: {type(exc).__name__}"
    return "ran: the all_reduce completed"


def _two_rank_work(tmp):
    """Phase 18 on each of two gloo ranks sharing card 0 (see
    phase_sharded_two_ranks); rank 0 returns the readings."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from eigensolver_gpu_torch import (SolverConfig, sygvdx, sygvdx_batched,
                                       zhegvdx_planar)
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel, bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel, ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, apply_q2_planar_kernel
    from eigensolver_gpu_torch.parallel import (comm, make_mesh, sygvdx_batched_sharded,
                                                sygvdx_sharded, zhegvdx_planar_batched_sharded)

    rank = dist.get_rank()
    out = {}
    cfg = SolverConfig(compute_dtype="float32", tridiag_mode="two")

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def launches(wrappers, reset=False):
        if reset:
            for fn in wrappers:
                fn.launches = 0
            return None
        return {fn.__name__: fn.launches for fn in wrappers}

    # tensor parallel, make_mesh(2): config 2 against phase 17's one-rank solve
    n, iu = N_REAL, IU_REAL
    a, b = _spd_on_card(torch, n, 0)
    real = (ql_panel, bulge_chase_kernel, apply_q2_kernel)
    launches(real, reset=True)
    comm.reset()
    res, ms = timed(lambda: sygvdx_sharded(a, b, make_mesh(2), il=1, iu=iu, cfg=cfg))
    got = launches(real)
    if got != {"ql_panel": n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}:
        raise RuntimeError(f"rank {rank}: tp launches {got}")
    if rank == 0:
        resid = _real_check(torch, res, a, b, n, iu, "two-rank tp config 2")
        one = torch.from_numpy(np.load(os.path.join(tmp, SHARED_W))).cuda()
        werr = float((res.w - one).abs().max() / one.abs().max())
        if not werr <= 1e-12:
            raise RuntimeError(f"two-rank tp eigenvalues {werr:.3e} from phase 17's")
        out["tp"] = {"ms": ms, "residual": resid, "werr": werr, "launches": got,
                     "collectives": dict(comm.calls), "by_stage": dict(comm.stages)}
    del a, b, res

    # data parallel, make_mesh(2, dp=2): phase 14's planar k-point batch
    mesh_dp = make_mesh(2, dp=2)
    batch, n, iu = K1_BATCH, N_BATCHED, IU_BATCHED
    planes = _batch_on_card(torch, "random_hpd_pair", n, batch)
    planar = (pchol_block_planar, ql_panel_planar, bulge_chase_planar_kernel,
              apply_q2_planar_kernel)
    launches(planar, reset=True)
    comm.reset()
    res, ms = timed(lambda: zhegvdx_planar_batched_sharded(*planes, mesh_dp, il=1, iu=iu,
                                                           cfg=cfg))
    got = launches(planar)
    want = {"pchol_block_planar": n // 128, "ql_panel_planar": n // BAND - 1,
            "bulge_chase_planar_kernel": 1, "apply_q2_planar_kernel": 1}
    if got != want:
        raise RuntimeError(f"rank {rank}: planar dp launches {got}, want {want}")
    if rank == 0:
        info = res.info.cpu().tolist()
        resid = _device_residual(torch, planes, res)
        if set(info) != {0} or not resid <= 1e-13 or tuple(res.zr.shape) != (batch, n, iu):
            raise RuntimeError(f"two-rank planar dp: info={info} residual={resid}")
        held = []
        for k in (0, batch - 1):
            single = zhegvdx_planar(*(x[k] for x in planes), il=1, iu=iu, cfg=cfg)
            held.append(_held_items(torch, (res.w[k], torch.complex(res.zr[k], res.zi[k])),
                                    (single.w, torch.complex(single.zr, single.zi)),
                                    f"two-rank planar dp item {k}"))
        out["planar_dp"] = {"ms": ms, "residual": resid, "held": held, "launches": got,
                            "collectives": dict(comm.calls)}
    del planes, res

    # data parallel: phase 15's real k-point batch
    a, b = _batch_on_card(torch, "random_spd_pair", n, batch)
    iu = IU_BATCHED_REAL
    launches(real, reset=True)
    comm.reset()
    res, ms = timed(lambda: sygvdx_batched_sharded(a, b, mesh_dp, il=1, iu=iu, cfg=cfg))
    got = launches(real)
    if got != {"ql_panel": n // BAND - 1, "bulge_chase_kernel": 1, "apply_q2_kernel": 1}:
        raise RuntimeError(f"rank {rank}: real dp launches {got}")
    if rank == 0:
        info = res.info.cpu().tolist()
        resid = _real_residual(torch, a, b, res)
        if set(info) != {0} or not resid <= 1e-13 or tuple(res.z.shape) != (batch, n, iu):
            raise RuntimeError(f"two-rank real dp: info={info} residual={resid}")
        held = []
        for k in (0, batch - 1):
            single = sygvdx(a[k], b[k], il=1, iu=iu, cfg=cfg)
            held.append(_held_items(torch, (res.w[k], res.z[k]), (single.w, single.z),
                                    f"two-rank real dp item {k}"))
        out["real_dp"] = {"ms": ms, "residual": resid, "held": held, "launches": got,
                          "collectives": dict(comm.calls)}
    dist.barrier()
    return out


def phase_sharded_two_ranks(torch):
    """Phase 18: two ranks sharing the card. First what NCCL does with two
    ranks on one device (expected to refuse). Then a gloo world of two
    ranks (torch.multiprocessing spawn, a fresh store), their collectives
    staged through host buffers by parallel/comm.py: sygvdx_sharded at
    n=4096, iu=512, mp, two-stage over make_mesh(2) (eigenvalues within
    1e-12 relative of phase 17's one-rank solve, residual <= 1e-13);
    zhegvdx_planar_batched_sharded on phase 14's 64 x random_hpd_pair(1024)
    (iu=128, mp, two-stage) over make_mesh(2, dp=2), 32 items a rank with
    one K1, K6, K8, K10 launch a step of its share (counted on each rank);
    sygvdx_batched_sharded on phase 15's real batch (iu=64). Each: info,
    residual over every item, items 0 and 63 against their unbatched
    solves (1e-12), wall ms of two processes time-sharing one card through
    host-staged collectives (no scaling figure)."""
    from eigensolver_gpu_torch.parallel.dryrun import run_world

    t0 = time.perf_counter()
    nccl = _nccl_two_ranks_one_card()
    log(f"sharded (two ranks): NCCL with two ranks on one card: {nccl} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out = run_world(2, _two_rank_work, (os.environ["CHIP_SMOKE_TMP"],), device_type="cuda",
                    backend="gloo")
    log(f"sharded (two ranks): gloo world of two ranks on one card in "
        f"{time.perf_counter() - t0:.1f} s (spawn, data on the card, the solves below); "
        "times are two processes time-sharing one card through host-staged collectives, "
        "not a scaling figure")
    tp = out["tp"]
    log(f"  sygvdx_sharded n={N_REAL} iu={IU_REAL} mp two-stage make_mesh(2): info=0 residual "
        f"{tp['residual']:.3e}, eigenvalues {tp['werr']:.2e} relative from phase 17's one-rank "
        f"solve, wall {tp['ms']:.1f} ms, launches a rank {tp['launches']}, collectives "
        f"{tp['collectives']} by stage {tp['by_stage']}")
    for key, what in (("planar_dp", f"zhegvdx_planar_batched_sharded {K1_BATCH} x "
                                    f"n={N_BATCHED} iu={IU_BATCHED}"),
                      ("real_dp", f"sygvdx_batched_sharded {K1_BATCH} x n={N_BATCHED} "
                                  f"iu={IU_BATCHED_REAL}")):
        r = out[key]
        log(f"  {what} mp two-stage make_mesh(2, dp=2): info all 0, residual (max over items) "
            f"{r['residual']:.3e}, items 0 and {K1_BATCH - 1} within "
            f"{max(h[0] for h in r['held']):.2e} (w) and {max(h[1] for h in r['held']):.2e} "
            f"(vectors) of their unbatched solves, wall {r['ms']:.1f} ms, launches a rank "
            f"{r['launches']}, collectives {r['collectives']}")
    out["nccl_two_ranks_one_card"] = nccl
    return out


PAD_W_TOL = 1e-10  # eigenvalues, relative to the largest selected |lambda| (PERF.md section 2)
PAD_RES_TOL = 1e-12  # ge_residual (PERF.md section 2)
PAD_SCALES = (1e-4, 1e-6, 1e-8)
PAD_BATCH_SCALES = (1e-6, 1.0, 1e6)


def _padded_cases():
    """(what, route, n, il, iu, cfg keywords, scales a solve, kernels it must
    launch, kernels it must not) of the padded phase. Real n = 130 pads to
    160 and planar n = 100 to 128 (nb_tridiag 32). K4 takes the real
    one-stage buckets whose size is a multiple of 512 and K2 the planar ones
    whose size is a multiple of 256, so neither runs at those sizes (the
    planar n = 100 pads its pencil to 128 before the Cholesky); the real
    n = 1000 case pads to 1024 and reaches K4."""
    mp = {"compute_dtype": "float32"}
    two = {"tridiag_mode": "two"}
    real_two = ("ql_panel", "bulge_chase_kernel", "apply_q2_kernel")
    planar_two = ("ql_panel_planar", "bulge_chase_planar_kernel", "apply_q2_planar_kernel")
    return [
        ("real mp one-stage use_pallas", "real", 130, 120, 130, dict(mp, use_pallas=True),
         [(s,) for s in PAD_SCALES], (), ("symv",)),
        ("real mp two-stage", "real", 130, 120, 130, dict(mp, **two),
         [(s,) for s in PAD_SCALES], real_two, ()),
        ("real mp one-stage use_pallas, K4's buckets", "real", 1000, 990, 1000,
         dict(mp, use_pallas=True), [(1e-6,)], ("symv",), ()),
        ("planar mp one-stage use_pallas", "planar", 100, 90, 100, dict(mp, use_pallas=True),
         [(s,) for s in PAD_SCALES], ("pchol_block_planar",), ("latrd_panel_planar",)),
        ("planar mp two-stage", "planar", 100, 90, 100, dict(mp, **two),
         [(s,) for s in PAD_SCALES], ("pchol_block_planar",) + planar_two, ()),
        ("planar fp64 one-stage", "planar", 100, 90, 100, {}, [(1e-8,)], (), ()),
        ("planar fp64 two-stage", "planar", 100, 90, 100, dict(two), [(1e-8,)], planar_two, ()),
        ("sygvdx_batched mp two-stage", "real", 130, 120, 130, dict(mp, **two),
         [PAD_BATCH_SCALES], real_two, ()),
        ("zhegvdx_planar_batched mp two-stage", "planar", 100, 90, 100, dict(mp, **two),
         [PAD_BATCH_SCALES], ("pchol_block_planar",) + planar_two, ()),
    ]


def phase_padded(torch):
    """Padded solves whose standard-form matrix has a small norm (A scaled
    1e-4, 1e-6, 1e-8; batches with items scaled 1e-6, 1 and 1e6), each
    against scipy.linalg.eigh on the host: eigenvalues within PAD_W_TOL of
    the largest selected |lambda| and ge_residual below PAD_RES_TOL, info 0,
    with the launches of every kernel wrapper of the solve (counters zeroed
    just before it, read just after). Returns the launches summed over the
    phase."""
    import numpy as np
    import scipy.linalg

    from eigensolver_gpu_torch import (
        SolverConfig,
        sygvdx,
        sygvdx_batched,
        zhegvdx_planar,
        zhegvdx_planar_batched,
    )
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel, bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.latrd import latrd_panel_planar
    from eigensolver_gpu_torch.ops.pchol import pchol_block_planar
    from eigensolver_gpu_torch.ops.ql_panel import ql_panel, ql_panel_planar
    from eigensolver_gpu_torch.ops.replay import apply_q2_kernel, apply_q2_planar_kernel
    from eigensolver_gpu_torch.ops.symv import hemv_planar, symv
    from eigensolver_gpu_torch.utils.convert import planar_from_numpy
    from eigensolver_gpu_torch.utils.testing import ge_residual

    wrappers = (pchol_block_planar, latrd_panel_planar, hemv_planar, symv, ql_panel,
                ql_panel_planar, bulge_chase_kernel, bulge_chase_planar_kernel,
                apply_q2_kernel, apply_q2_planar_kernel)
    totals = {fn.__name__: 0 for fn in wrappers}
    t_phase = time.perf_counter()
    for what, route, n, il, iu, kw, scale_sets, must, must_not in _padded_cases():
        cfg = SolverConfig(**kw)
        make = "random_spd_pair" if route == "real" else "random_hpd_pair"
        for scales in scale_sets:
            pairs = [_pair(make, n, k) for k in range(len(scales))]
            a = np.stack([p[0] * s for p, s in zip(pairs, scales)])
            b = np.stack([p[1] for p in pairs])
            if len(scales) == 1:
                a, b = a[0], b[0]
            for fn in wrappers:
                fn.launches = 0
            t0 = time.perf_counter()
            if route == "real":
                at, bt = (torch.tensor(x, device="cuda") for x in (a, b))
                res = (sygvdx_batched if a.ndim == 3 else sygvdx)(at, bt, il=il, iu=iu, cfg=cfg)
                w, z = res.w.cpu().numpy(), res.z.cpu().numpy()
            else:
                args = planar_from_numpy(a, b, device="cuda", dtype=torch.float64)
                fn = zhegvdx_planar_batched if a.ndim == 3 else zhegvdx_planar
                res = fn(*args, il=il, iu=iu, cfg=cfg)
                w = res.w.cpu().numpy()
                z = res.zr.cpu().numpy() + 1j * res.zi.cpu().numpy()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {fn.__name__: fn.launches for fn in wrappers}
            info = np.atleast_1d(res.info.cpu().numpy()).tolist()
            errs = []
            for k in range(len(scales)):
                ak, bk = (a[k], b[k]) if a.ndim == 3 else (a, b)
                wk, zk = (w[k], z[k]) if a.ndim == 3 else (w, z)
                ref = scipy.linalg.eigh(ak, bk, eigvals_only=True, subset_by_index=[il - 1, iu - 1])
                werr = float(np.abs(wk - ref).max() / np.abs(ref).max())
                finite = bool(np.isfinite(wk).all() and np.isfinite(zk).all())
                errs.append((werr, ge_residual(ak, bk, wk, zk) if finite else float("inf")))
            launched = {k: v for k, v in counts.items() if v}
            log(f"padded {what} n={n} il={il} iu={iu} A x {scales}: eigenvalues "
                f"{', '.join(f'{e[0]:.2e}' for e in errs)} relative, ge_residual "
                f"{', '.join(f'{e[1]:.2e}' for e in errs)}, info {info}, {ms:.1f} ms, "
                f"launches {launched}")
            for key, v in counts.items():
                totals[key] += v
            if set(info) != {0} or not all(e[0] < PAD_W_TOL and e[1] < PAD_RES_TOL
                                           for e in errs):
                raise RuntimeError(f"padded {what} A x {scales} wrong: info {info}, "
                                   f"errors {errs}")
            if any(not counts[k] for k in must) or any(counts[k] for k in must_not):
                raise RuntimeError(f"padded {what}: launches {counts}, want {must} launched "
                                   f"and {must_not} not")
    log(f"padded phase: {time.perf_counter() - t_phase:.1f} s; launches over the phase "
        f"{ {k: v for k, v in totals.items() if v} }")
    return totals


def _with(torch, check_batched, entry):
    """The kernel's entry with its batched readings added by check_batched."""
    check_batched(torch, entry)
    return entry


def _kernels_k1_k2(torch):
    kernels = [check_k1(torch), check_k2(torch)]
    check_k1_batched(torch, kernels[0])
    check_k2_batched(torch, kernels[1])
    return {"kernels": kernels}


def _main_real(torch):
    phase_reference(torch)
    symv = phase_main_real(torch)
    phase_reference_real(torch)
    phase_reference_embedded(torch)
    return {"launches": {"symv": symv}}


def _new_routes(torch):
    args = _main_args(torch)
    phase_trinv(torch, args)
    phase_ozaki(torch, args)
    phase_stedc(torch, args)
    return {}


# The checks and phases run in groups, each in a process of its own: in one
# long process the profiler has stopped catching device records (four smoke
# runs in a row on one day, from two different points on), while a fresh
# process caught them. A group whose profiles caught nothing is run once
# more in a new process. K5 and K6 run apart since their batched checks: in
# one process with both, K6's batched profiles caught nothing, twice in a
# row on the card.
GROUPS = {
    "K1, K2": _kernels_k1_k2,
    "K3, K4": lambda torch: {"kernels": [_with(torch, check_k3_batched, check_k3(torch)),
                                         _with(torch, check_k4_batched, check_k4(torch))]},
    "K5": lambda torch: {"kernels": [_with(torch, check_k5_batched, check_k5(torch))]},
    "K6": lambda torch: {"kernels": [_with(torch, check_k6_batched, check_k6(torch))]},
    "K7": lambda torch: {"kernels": [_with(torch, check_k7_batched, check_k7(torch))]},
    "K8": lambda torch: {"kernels": [_with(torch, check_k8_batched, check_k8(torch))]},
    "K9, K10": lambda torch: {"kernels": [
        _with(torch, check_k9_batched, check_k9(torch)),
        _with(torch, check_k10_batched, check_k10(torch))]},
    "main": lambda torch: {"launches": phase_main(torch)},
    "main (real)": _main_real,
    "padded (C1)": lambda torch: {"padded": phase_padded(torch)},
    "main (real, two-stage)": lambda torch: {"launches": phase_main_real_two(torch)},
    "main (planar, two-stage)": lambda torch: {"launches": phase_main_planar_two(torch)},
    "main (batched)": phase_main_batched,
    "main (batched, two-stage)": lambda torch: {"batched": phase_batched_two_stage(torch)},
    "main (batched real, two-stage)": lambda torch: {
        "batched_real": phase_batched_real_two_stage(torch)},
    "main (batched, use_pallas)": lambda torch: {"pallas": phase_batched_pallas(torch)},
    "main (embedded)": lambda torch: {"embedded": phase_embedded(torch)},
    "trinv, ozaki, stedc": _new_routes,
    "sharded (tp, one rank)": phase_sharded_tp,
    "sharded (two ranks)": lambda torch: {"two_ranks": phase_sharded_two_ranks(torch)},
}
# the host data each group reads, made in its process before its turn (_prepare):
# (fixture name, n, number of seeds from 0, or a tuple of seeds)
PREPARE = {
    "main": [("random_hpd_pair", N_MAIN, (0,))],
    "main (real)": [("random_hpd_pair", N_REF, (1,)), ("random_spd_pair", N_REAL, (0,)),
                    ("random_spd_pair", N_REF_REAL, (1,))],
    "main (real, two-stage)": [("random_spd_pair", N_REAL, (0,)),
                               ("random_spd_pair", N_PLAIN_ROUTE, (0,))],
    "main (planar, two-stage)": [("random_hpd_pair", N_MAIN, (0,)),
                                 ("random_hpd_pair", N_PLAIN_ROUTE, (2,))],
    "main (batched)": [("random_hpd_pair", N_BATCHED, K1_BATCH),
                       ("random_spd_pair", N_BATCHED, K1_BATCH)],
    "main (batched, two-stage)": [("random_hpd_pair", N_BATCHED, K1_BATCH)],
    "main (batched real, two-stage)": [("random_spd_pair", N_BATCHED, K1_BATCH)],
    "main (batched, use_pallas)": [("random_hpd_pair", N_BATCHED, K1_BATCH),
                                   ("random_spd_pair", N_BATCHED, K1_BATCH)],
    "main (embedded)": [("random_hpd_pair", N_MAIN, (0,)),
                        ("random_hpd_pair", N_EMBED_BATCHED, EMBED_BATCH)],
    "trinv, ozaki, stedc": [("random_hpd_pair", N_MAIN, (0,)), ("qe_style_pair", N_MAIN, (0,))],
    "sharded (tp, one rank)": [("draws", N_TP, (0,)), ("draws", N_REAL, (0,))],
}
# BLAS threads of a group's process: while it prepares, the group before it
# runs and is timed, and keeps the host's other cores
HOST_THREADS = "2"
RESULT_TAG = "chip_smoke group result: "
PROFILER_EXIT = 75  # a group's exit code when its profiles caught no record


class ProfilerDropped(RuntimeError):
    """The profiler caught no record of a kernel in any of its tries."""


GO = "go\n"  # the line that lets a started group's process run


def _start_group(name):
    """A child process for one group. It imports torch and the port and
    makes its host data (_prepare), then waits for GO on its standard
    input, so that both overlap the group before it."""
    env = dict(os.environ, OMP_NUM_THREADS=HOST_THREADS, OPENBLAS_NUM_THREADS=HOST_THREADS,
               MKL_NUM_THREADS=HOST_THREADS)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--group", name],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _go(proc):
    proc.stdin.write(GO)
    proc.stdin.close()


def _run_group(proc):
    """Pass the lines of a group's process through until it ends; returns
    (exit code, result dict or None)."""
    result = None
    try:
        for line in proc.stdout:
            if line.startswith(RESULT_TAG):
                result = json.loads(line[len(RESULT_TAG):])
            else:
                print(line, end="", flush=True)
    finally:
        proc.stdout.close()
        code = proc.wait()
    return code, result


def _merge_result(result, kernels, launches, readings):
    """Add one group's result to the lists the last lines are made from."""
    kernels += result.get("kernels", [])
    launches.update(result.get("launches", {}))
    readings.update({k: v for k, v in result.items()
                     if k in ("batched", "batched_real", "embedded", "batched_one_stage_ms",
                              "batched_real_one_stage_ms", "tp", "two_ranks", "pallas",
                              "padded")})


def _prepare(name):
    """Make the group's host data (PREPARE) on one thread."""
    for make, n, seeds in PREPARE.get(name, ()):
        for k in range(seeds) if isinstance(seeds, int) else seeds:
            _pair(make, n, k)


def _group_main(name):
    """The child process of one group: import, make the host data, wait for
    GO, run the group, print its result. Nothing touches the card before GO:
    a profile taken before a group's work (to set the profiler up early)
    left every later profile of K6's group without a device record, in
    both of its processes."""
    import numpy  # noqa: F401 -- imported before GO, as are the next three
    import scipy.linalg  # noqa: F401
    import torch

    import eigensolver_gpu_torch  # noqa: F401

    try:
        _prepare(name)
    except Exception:  # noqa: BLE001 -- report and fail the group
        traceback.print_exc()
        return 1
    if sys.stdin.readline() != GO:  # the parent ended before this group's turn
        return 1
    try:
        result = GROUPS[name](torch)
    except ProfilerDropped:
        traceback.print_exc()
        return PROFILER_EXIT
    except Exception:  # noqa: BLE001 -- report and fail the group
        traceback.print_exc()
        return 1
    print(RESULT_TAG + json.dumps(result), flush=True)
    return 0


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
    import shutil
    import tempfile

    # files one group leaves for a later one (phase 17's eigenvalues for phase 18)
    os.environ["CHIP_SMOKE_TMP"] = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _main_groups(torch)
    finally:
        shutil.rmtree(os.environ["CHIP_SMOKE_TMP"], ignore_errors=True)


def _main_groups(torch):
    """main's work once its temporary directory is made."""
    kernels, launches, k1_batched, readings = [], {}, None, {}
    names = list(GROUPS)
    waiting = None
    try:
        phase_device(torch)
        # the first group's process starts (and waits) while nvcc builds
        waiting = _start_group(names[0])
        phase_build()
    except Exception:  # noqa: BLE001 -- report and fail the smoke run
        traceback.print_exc()
        if waiting is not None:
            waiting.kill()
            waiting.wait()
        return 1
    try:
        for i, name in enumerate(names):
            # the next group's process starts (imports, makes its host data)
            # while this one runs
            proc, waiting = waiting, None
            t0 = time.perf_counter()
            _go(proc)
            if i + 1 < len(names):
                waiting = _start_group(names[i + 1])
            code, result = _run_group(proc)
            if code == PROFILER_EXIT:
                log(f"group {name}: the profiler caught no record; run again in a new process")
                proc = _start_group(name)
                _go(proc)
                code, result = _run_group(proc)
            if code != 0 or result is None:
                print(f"chip_smoke: group {name} failed (exit {code})", file=sys.stderr)
                return 1
            log(f"group {name}: {time.perf_counter() - t0:.1f} s")
            _merge_result(result, kernels, launches, readings)
            k1_batched = result.get("k1_batched", k1_batched)
    finally:
        if waiting is not None:
            waiting.kill()
            waiting.wait()
    kernels[0]["batched"]["launches"] = k1_batched
    two, real = readings["batched"], readings["batched_real"]
    for k in kernels:  # K5-K10: launches a batched two-stage solve of the k-point batch
        for route in (two, real):
            if k["name"] in route["launches"]:
                k["batched"]["launches"] = route["launches"][k["name"]]
    log(f"the k-point batch ({K1_BATCH} x n={N_BATCHED} iu={IU_BATCHED} mp), one solve each: "
        f"one-stage batched {readings['batched_one_stage_ms']:.1f} ms, two-stage batched "
        f"{two['batched_two_stage_ms']:.1f} ms, two-stage item by item (estimated from four "
        f"items) {two['item_by_item_ms']:.1f} ms")
    log(f"the real k-point batch ({K1_BATCH} x n={N_BATCHED} iu={IU_BATCHED_REAL} mp), one solve "
        f"each: one-stage batched {readings['batched_real_one_stage_ms']:.1f} ms, two-stage "
        f"batched {real['batched_real_two_stage_ms']:.1f} ms, two-stage item by item (estimated "
        f"from four items) {real['real_item_by_item_ms']:.1f} ms")
    pallas = readings["pallas"]
    for k in kernels:  # K2, K4: launches a batched use_pallas solve of the k-point batch
        for route in (pallas["planar"], pallas["real"]):
            if k["name"] in route["launches"]:
                k["batched"]["launches"] = route["launches"][k["name"]]
    for name, one_stage in (("planar", readings["batched_one_stage_ms"]),
                            ("real", readings["batched_real_one_stage_ms"])):
        r = pallas[name]
        log(f"the {name} k-point batch with use_pallas=True, one-stage: one batched solve "
            f"{r['ms']:.1f} ms, item by item (estimated from four items) "
            f"{r['item_by_item_ms']:.1f} ms; without use_pallas (phase 10) one batched solve "
            f"{one_stage:.1f} ms")
    emb = readings["embedded"]
    log(f"the complex embedding (fp64): n={N_MAIN} iu={IU_MAIN} {emb['embedded_ms']:.1f} ms, "
        f"{EMBED_BATCH} x n={N_EMBED_BATCHED} iu={IU_EMBED_BATCHED} batched "
        f"{emb['embedded_batched_ms']:.1f} ms")
    tp, two = readings["tp"], readings["two_ranks"]
    log(f"sharded: config 5 (n={N_TP} iu={IU_TP} mp two-stage) on make_mesh(1) "
        f"{tp['ms']:.1f} ms, residual {tp['residual']:.3e}, peak {tp['peak_gib']:.2f} GiB; two "
        f"ranks time-sharing the card (gloo, host-staged): tp n={N_REAL} "
        f"{two['tp']['ms']:.1f} ms, planar dp batch {two['planar_dp']['ms']:.1f} ms, real dp "
        f"batch {two['real_dp']['ms']:.1f} ms; NCCL, two ranks on one card: "
        f"{two['nccl_two_ranks_one_card']}")
    for k in kernels:  # K5, K7, K9: launches on the tensor-parallel path (phase 17)
        if k["name"] in tp["launches"]:
            k["tp"] = {"launches": tp["launches"][k["name"]]}
            if not k["tp"]["launches"]:
                print(f"chip_smoke: {k['name']} was never launched on the tp path",
                      file=sys.stderr)
                return 1
    for k in kernels:  # launches over the padded phase (C1)
        if k["name"] in readings["padded"]:
            k["padded"] = {"launches": readings["padded"][k["name"]]}
    for k in kernels:
        k.setdefault("launches", launches.get(k["name"]))
        if not k["launches"]:
            print(f"chip_smoke: {k['name']} was never launched on its path", file=sys.stderr)
            return 1
        for entry in (k, k.get("batched", {})):
            if "batched" in k and not entry.get("launches", 1):
                print(f"chip_smoke: batched {k['name']} was never launched on its path",
                      file=sys.stderr)
                return 1
            for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
                if entry.get(key) is not None and not math.isfinite(entry[key]):
                    print(f"chip_smoke: non-finite {key} for {k['name']}", file=sys.stderr)
                    return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--group":
        sys.exit(_group_main(sys.argv[2]))
    sys.exit(main())
