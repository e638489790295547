#!/usr/bin/env python3
"""Redesigned kernels of this tree against their parents' sources, timed in
turns in one process on one card.

    git archive <commit> | tar -x -C <dir>       # any directory
    python3 tools/kernel_ab.py <dir>             # K2 and K9 (<commit>: b9bcfb8)
    python3 tools/kernel_ab.py --symv <dir>      # K3 and K4 (<commit>: 376279d)
    python3 tools/kernel_ab.py --batch <dir>     # K2, K3, K4 (<commit>: b9de9c6)

<dir> holds a checkout whose C entries are those in PARENT_ENTRIES for the
mode; the tool reads them from <dir>'s sources and refuses a checkout whose
entries differ. Each source is built, the parent's and this tree's, into
its own library under eigensolver_gpu_torch/build/ab/. Then, on the same
inputs:

  K2 -- one panel at mb = pe = 4096, 2048 and 1024 (contiguous planes):
        the parent's (65 launches a panel) and this tree's kernel in turns
        (parent, new, new, parent), CUDA-event ms of each turn, kernel
        launches a call by the profiler, and the largest difference between
        the two outputs relative to the parent's;
  K9 -- n = m = 4096, b = 32, g = 96, fp32: the window passes (the
        parent's all-slots ``window_qs``, imported from <dir>, and this
        tree's ``window_store``) and the bare kernels on their prepared
        windows, in turns, with kernel launches a call by the profiler and
        whether the two kernels give the same bits; then 20 calls of
        this tree's kernel on the same inputs, fp32 (g = 96) and fp64
        (g = b), and how many give other bits than the first;
  K4 -- (--symv) fp32 at n = 4096 and at the real one-stage solve's
        extents 256, 511, 1023, 2047, 3071 and 4095 on the lda = 4096 view,
        and fp64 at n = 4096; K3 at n = 4096 and extents 2047 and 4095: the
        parent's (two launches a call) and this tree's kernel in turns, warm
        (CUDA events over back-to-back calls) and cold (the profiler's
        kernel durations, a 256 MB buffer written and read before each
        call), torch.mv on the same view, kernel launches a call, and
        whether the two give the same bits; then K4's device total over one
        real one-stage dsygvdx solve (n = 4096, iu = 512, fp32 pipeline,
        use_pallas=True) with the solve's device busy time, the parent's
        kernel (through a wrapper of this tool in place of ops/symv.symv)
        and this tree's in turns.
  K2, K3, K4 -- (--batch) the kernels before their batch axis against this
        tree's on one problem (batch 1): K2 at mb = pe = 4096, 2048 and
        1024, K4 fp32 and fp64 and K3 at n = 4096, warm (and K3, K4 cold),
        in turns, with whether the two give the same bits.

Prints one line a measurement with the card's name and power limit first.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from eigensolver_gpu_torch.utils import kernel_guard  # noqa: E402
from eigensolver_gpu_torch.utils.timer import device_ms  # noqa: E402

# the C entries of the parents that this tool calls, as declared, by mode
PARENT_ENTRIES = {
    "k2k9": [
        ("latrd_panel.cu", "latrd_panel_planar_launch(const float* ar, const float* ai, "
                           "int lda, int mb, int pe, int nb, float* pan, float* scal, float* y, "
                           "void* stream)"),
        ("replay.cu", "apply_q2_f32_launch(const float* qw, float* y, int ldy, int n, int m, "
                      "int b, int g, int n_waves, int n_slots, void* stream)"),
    ],
    # the two-launch design, whose scratch is planes x ceil(n / 64) x n
    "symv": [
        ("symv.cu", "symv_f32_launch(const float* a, int lda, int n, const float* v, "
                    "float* part, float* y, void* stream)"),
        ("symv.cu", "symv_f64_launch(const double* a, int lda, int n, const double* v, "
                    "double* part, double* y, void* stream)"),
        ("symv.cu", "hemv_planar_launch(const float* ar, const float* ai, int lda, int n, "
                    "const float* vr, const float* vi, float* part, float* y, void* stream)"),
    ],
    # the one-launch designs before the batch axis (symv_part_elems, a scratch)
    "batch": [
        ("latrd_panel.cu", "latrd_panel_planar_launch(const float* ar, const float* ai, "
                           "int lda, int mb, int pe, int nb, float* pan, float* scal, "
                           "float* scratch, void* stream)"),
        ("symv.cu", "symv_f32_launch(const float* a, int lda, int n, const float* v, "
                    "float* part, float* y, void* stream)"),
        ("symv.cu", "symv_f64_launch(const double* a, int lda, int n, const double* v, "
                    "double* part, double* y, void* stream)"),
        ("symv.cu", "hemv_planar_launch(const float* ar, const float* ai, int lda, int n, "
                    "const float* vr, const float* vi, float* part, float* y, void* stream)"),
    ],
}


def _check_parent(csrc: pathlib.Path, mode: str):
    """Raise unless <dir>'s sources declare the mode's PARENT_ENTRIES as they
    are (and, for the two-launch symv, no symv_part_elems)."""
    for name, want in PARENT_ENTRIES[mode]:
        text = " ".join((csrc / name).read_text().split())
        fn = want[: want.index("(")]
        at = text.find(f'extern "C" int {fn}(')
        got = text[at + len('extern "C" int '): text.index(")", at) + 1] if at >= 0 else None
        if got != want or (mode == "symv" and "symv_part_elems" in text):
            raise SystemExit(f"kernel_ab: {csrc / name} declares {got!r}, not {want!r} "
                             "(or has symv_part_elems): this tool calls only the parents' C "
                             "entries")


def _build(src: pathlib.Path, tag: str) -> ctypes.CDLL:
    out = kernel_guard.BUILD / "ab" / f"lib{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernel_guard._nvcc(), *kernel_guard.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    return ctypes.CDLL(str(out))


def _launches(fn, key):
    """Kernels whose name holds ``key`` launched by one call of ``fn``, from
    the profiler's device records; a profile that caught none of them (the
    profiler drops records now and then) is taken again, up to three calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = sum(key in e.name() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA)
        if launched:
            break
    return launched


def _turns(label_a, fa, label_b, fb, iters):
    """ms of fa and fb in the order a, b, b, a."""
    a1 = device_ms(fa, iters=iters)
    b1 = device_ms(fb, iters=iters)
    b2 = device_ms(fb, iters=iters)
    a2 = device_ms(fa, iters=iters)
    print(f"  {label_a}: {a1:.4f}, {a2:.4f} ms; {label_b}: {b1:.4f}, {b2:.4f} ms", flush=True)


def k2(parent_lib, new_lib, dev):
    V, I = ctypes.c_void_p, ctypes.c_int
    parent_lib.latrd_panel_planar_launch.argtypes = [V] * 2 + [I] * 4 + [V] * 4
    new_lib.latrd_panel_planar_launch.argtypes = [V, V, I, ctypes.c_longlong, I, I, I, V, V, V,
                                                  I, V]
    for lib in (parent_lib, new_lib):
        lib.latrd_panel_planar_launch.restype = ctypes.c_int
    new_lib.latrd_panel_scratch_floats.restype = ctypes.c_int
    rng = np.random.default_rng(2)
    nb = 32
    for mb in (4096, 2048, 1024):
        t = rng.standard_normal((mb, mb)) + 1j * rng.standard_normal((mb, mb))
        t = (t + t.conj().T) / 2
        ar = torch.tensor(t.real, dtype=torch.float32, device=dev)
        ai = torch.tensor(t.imag, dtype=torch.float32, device=dev)
        del t
        stream = torch.cuda.current_stream().cuda_stream

        def parent():
            pan = torch.zeros((6, nb, mb), device=dev)
            scal = torch.zeros((4, nb), device=dev)
            y = torch.empty((2, mb), device=dev)
            kernel_guard.check(parent_lib.latrd_panel_planar_launch(
                ar.data_ptr(), ai.data_ptr(), mb, mb, mb, nb, pan.data_ptr(), scal.data_ptr(),
                y.data_ptr(), stream), "parent K2")
            return pan, scal

        def new():
            pan = torch.empty((6, nb, mb), device=dev)
            scal = torch.empty((4, nb), device=dev)
            scr = torch.empty((new_lib.latrd_panel_scratch_floats(mb),), device=dev)
            kernel_guard.check(new_lib.latrd_panel_planar_launch(  # one problem: batch 1
                ar.data_ptr(), ai.data_ptr(), mb, 0, mb, mb, nb, pan.data_ptr(), scal.data_ptr(),
                scr.data_ptr(), 1, stream), "K2")
            return pan, scal

        (pp, ps), (npn, ns) = parent(), new()
        diff = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                   for x, y in ((npn, pp), (ns, ps)))
        print(f"K2 mb=pe={mb}: launches a call parent {_launches(parent, 'latrd_')}, "
              f"new {_launches(new, 'latrd_')}; new vs parent outputs, max relative "
              f"difference {diff:.2e}", flush=True)
        _turns("parent (65 launches a panel)", parent, "new (one cooperative launch)", new,
               iters=5)
        del ar, ai


def k9(parent_dir, parent_lib, new_lib, dev):
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.replay import window_store
    from eigensolver_gpu_torch.ops.sb2st import dense_to_band

    spec = importlib.util.spec_from_file_location(
        "parent_replay", parent_dir / "eigensolver_gpu_torch" / "ops" / "replay.py")
    parent_replay = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_replay)

    n, b, g, m = 4096, 32, 96, 4096
    rng = np.random.default_rng(9)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    band = dense_to_band(torch.tensor(a, dtype=torch.float32, device=dev), b)
    del a
    _, _, vt, taut = bulge_chase_kernel(band, b)
    y0 = torch.tensor(rng.standard_normal((n, m)), dtype=torch.float32, device=dev)
    qw = parent_replay.window_qs(vt, taut, n, b, g)
    store, table = window_store(vt, taut, n, b, g)
    row0 = torch.from_numpy(table["row0"].astype(np.int32)).to(dev)
    l_win = table["geo"]["l_win"]
    print(f"K9 n={n} m={m} b={b} g={g} fp32: parent window layout {qw.numel() * 4 / 1e6:.1f} MB "
          f"({qw.shape[0]} x {qw.shape[1]} slots), store {store.numel() * 4 / 1e6:.1f} MB "
          f"({store.shape[0]} windows)", flush=True)
    _turns("window pass, parent window_qs", lambda: parent_replay.window_qs(vt, taut, n, b, g),
           "window pass, window_store", lambda: window_store(vt, taut, n, b, g), iters=3)
    stream = torch.cuda.current_stream().cuda_stream
    fp = parent_lib.apply_q2_f32_launch
    fp.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fp.restype = ctypes.c_int
    y = y0.clone()

    def parent():
        y.copy_(y0)
        kernel_guard.check(fp(qw.data_ptr(), y.data_ptr(), m, n, m, b, g, qw.shape[0],
                              qw.shape[1], stream), "parent K9")
        return y

    fn = new_lib.apply_q2_f32_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def new():
        y.copy_(y0)
        kernel_guard.check(fn(store.data_ptr(), row0.data_ptr(), row0.numel(), y.data_ptr(),
                              m, n, m, l_win, 1, stream), "K9")
        return y

    want = parent().clone()
    got = new().clone()
    print(f"K9 kernels: launches a call parent {_launches(parent, 'replay_wave')}, new "
          f"{_launches(new, 'replay_kernel')}; new and parent give the same bits: "
          f"{torch.equal(got, want)} (max abs difference {float((got - want).abs().max()):.2e})",
          flush=True)
    y.copy_(y0)
    copy_ms = device_ms(lambda: y.copy_(y0), iters=10)
    print(f"  (each timed call below includes a copy of y: {copy_ms:.4f} ms)")
    _turns("kernel, parent (212 launches)", parent, "kernel, new (one launch)", new, iters=3)
    del qw, store, y, y0
    k9_repeat(new_lib, dev)


def k9_repeat(lib, dev, calls=20):
    """Repeated calls of this tree's kernel on the same inputs: how many give
    other bits than the first, fp32 at the main path's g = 96 and fp64 at
    the pure-fp64 path's g = b, n = m = 4096."""
    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.replay import window_store
    from eigensolver_gpu_torch.ops.sb2st import dense_to_band

    n, b, m = 4096, 32, 4096
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    y0 = rng.standard_normal((n, m))
    for dtype, g, name in ((torch.float32, 96, "apply_q2_f32_launch"),
                           (torch.float64, b, "apply_q2_f64_launch")):
        _, _, vt, taut = bulge_chase_kernel(dense_to_band(torch.tensor(a, dtype=dtype, device=dev),
                                                          b), b)
        store, table = window_store(vt, taut, n, b, g)
        row0 = torch.from_numpy(table["row0"].astype(np.int32)).to(dev)
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        outs = []
        for _ in range(calls):
            y = torch.tensor(y0, dtype=dtype, device=dev)
            kernel_guard.check(fn(store.data_ptr(), row0.data_ptr(), row0.numel(), y.data_ptr(),
                                  m, n, m, table["geo"]["l_win"], 1,
                                  torch.cuda.current_stream().cuda_stream), "K9")
            outs.append(y)
        torch.cuda.synchronize()
        differ = sum(not torch.equal(x, outs[0]) for x in outs[1:])
        print(f"K9 {str(dtype)[6:]} n={n} m={m} b={b} g={g}: {differ} of {calls - 1} repeated "
              "calls give other bits than the first", flush=True)
        del outs, store


def _mv_entries(lib, kind):
    """The argument types of a library's K4 and K3 entries, by its kind:
    "two_launch" (376279d), "one_launch" (b9de9c6: the same entries, and
    symv_part_elems) or "batched" (this tree: a batch and its strides)."""
    V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kind = kind
    batched = kind == "batched"
    for name in ("symv_f32_launch", "symv_f64_launch"):
        getattr(lib, name).argtypes = ([V, I, L, I, V, L, V, V, I, V] if batched
                                       else [V, I, I, V, V, V, V])
    lib.hemv_planar_launch.argtypes = ([V, V, I, L, I, V, V, L, V, V, I, V] if batched
                                       else [V, V, I, I, V, V, V, V, V])
    if kind != "two_launch":
        lib.symv_part_elems.argtypes = [I, I]
        lib.symv_part_elems.restype = ctypes.c_longlong


def _mv_call(lib, mats, vecs, c):
    """A caller of one library's K4 (one matrix) or K3 (two planes) on the
    leading c x c block of ``mats`` and the heads of ``vecs``; the scratch
    and y are made anew each call, as the wrapper does. The two-launch
    parent's scratch is planes x ceil(c / 64) x c; the others'
    symv_part_elems."""
    a, planes = mats[0], len(mats)
    stream = torch.cuda.current_stream().cuda_stream
    if planes == 2:
        fn = lib.hemv_planar_launch
    else:
        fn = lib.symv_f64_launch if a.dtype == torch.float64 else lib.symv_f32_launch

    def call():
        elems = planes * -(-c // 64) * c if lib.kind == "two_launch" else lib.symv_part_elems(
            c, planes)
        part = torch.empty(elems, dtype=a.dtype, device=a.device)
        y = torch.empty(planes * c, dtype=a.dtype, device=a.device)
        if lib.kind == "batched":  # one problem: batch 1
            status = fn(*(m.data_ptr() for m in mats), a.stride(0), 0, c,
                        *(x.data_ptr() for x in vecs), c, part.data_ptr(), y.data_ptr(), 1,
                        stream)
        else:
            status = fn(*(m.data_ptr() for m in mats), a.stride(0), c,
                        *(x.data_ptr() for x in vecs), part.data_ptr(), y.data_ptr(), stream)
        kernel_guard.check(status, "symv A/B launch")
        return y

    return call


def mv_ab(parent_lib, new_lib, dev):
    """K4 and K3: the parent and this tree in turns, warm and cold, with
    torch.mv on the same view."""
    from chip_smoke import _cold_ms, _mv_bound
    from eigensolver_gpu_torch.utils.precision import true_fp32

    _mv_entries(parent_lib, "two_launch")
    _mv_entries(new_lib, "batched")
    rng = np.random.default_rng(12)
    t = rng.standard_normal((4096, 4096))
    a64 = torch.tensor((t + t.T) / 2, device=dev)
    v64 = torch.tensor(rng.standard_normal(4096), device=dev)
    a32, v32 = a64.float(), v64.float()
    up = torch.triu(torch.tensor(rng.standard_normal((4096, 4096)), device=dev).float(), 1)
    ai, vi = up - up.T, torch.tensor(rng.standard_normal(4096), device=dev).float()
    ac, vc = torch.complex(a32, ai), torch.complex(v32, vi)
    del t, up
    cases = [("K4 fp32", (a32,), (v32,), c) for c in (4096, 256, 511, 1023, 2047, 3071, 4095)]
    cases += [("K4 fp64", (a64,), (v64,), 4096), ("K3", (a32, ai), (v32, vi), 4096),
              ("K3", (a32, ai), (v32, vi), 2047), ("K3", (a32, ai), (v32, vi), 4095)]
    for label, mats, vecs, c in cases:
        views = tuple(m[:c, :c] for m in mats)
        heads = tuple(x[:c] for x in vecs)
        parent, new = _mv_call(parent_lib, views, heads, c), _mv_call(new_lib, views, heads, c)
        yp, yn = parent().clone(), new().clone()
        diff = float((yn - yp).abs().max()) / max(float(yp.abs().max()), 1e-30)
        bnd, _ = _mv_bound(c, len(mats), itemsize=mats[0].element_size())
        if len(mats) == 2:
            lib_fn = lambda: torch.mv(ac[:c, :c], vc[:c])  # noqa: E731
        else:
            lib_fn = lambda: torch.mv(views[0], heads[0])  # noqa: E731
        print(f"{label} c={c} (lda 4096): launches a call parent {_launches(parent, '')}, "
              f"new {_launches(new, '')}; same bits {torch.equal(yp, yn)} (max relative "
              f"difference {diff:.2e}); bound {bnd:.5f} ms (bytes)", flush=True)
        _turns("  warm: parent (two launches)", parent, "new (one launch)", new, iters=100)
        cold = [_cold_ms(torch, f) for f in (parent, new, new, parent)]
        with true_fp32():
            mv_warm = device_ms(lib_fn, iters=100)
            mv_cold = _cold_ms(torch, lib_fn)
        print(f"  cold: parent {cold[0]:.4f}, {cold[3]:.4f} ms; new {cold[1]:.4f}, {cold[2]:.4f} "
              f"ms ({bnd / max(cold[1], cold[2]):.0%} of the bound); torch.mv on the view "
              f"{mv_warm:.4f} warm, {mv_cold:.4f} cold", flush=True)


def k4_solve(parent_lib, dev):
    """K4's device total and the device busy time over one real one-stage
    use_pallas=True solve, with the parent's kernel put in place of
    ops/symv.symv by a wrapper of this tool, and with this tree's, in turns."""
    from chip_smoke import _device_records
    from eigensolver_gpu_torch import SolverConfig, dsygvdx
    from eigensolver_gpu_torch.ops import sytrd
    from eigensolver_gpu_torch.ops.symv import symv
    from eigensolver_gpu_torch.utils.convert import dense_from_numpy
    from eigensolver_gpu_torch.utils.testing import random_spd_pair

    n, iu = 4096, 512
    a, b = dense_from_numpy(*random_spd_pair(n, seed=0), device=dev, dtype=torch.float64)
    cfg = SolverConfig(compute_dtype="float32", use_pallas=True)

    def parent_symv(x, v, extent=None):
        c = x.shape[0] if extent is None else int(extent)
        return _mv_call(parent_lib, (x[:c, :c],), (v[:c].contiguous(),), c)()

    def solve(which):
        sytrd.symv = parent_symv if which == "parent" else symv
        try:
            return dsygvdx(a, b, il=1, iu=iu, cfg=cfg)
        finally:
            sytrd.symv = symv

    for which in ("parent", "new"):  # warm-up
        solve(which)
    for which in ("parent", "new", "new", "parent"):
        records = _device_records(torch, lambda: solve(which), ("symv",))
        k4 = [ns for name, ns in records
              if any(k in name for k in ("symv_tiles", "sum_partials", "symv_kernel"))]
        print(f"K4 in one real one-stage solve (n={n}, iu={iu}, mp, use_pallas=True), {which}: "
              f"{sum(k4) / 1e6:.3f} ms in {len(k4)} kernels; device busy "
              f"{sum(ns for _, ns in records) / 1e6:.1f} ms over {len(records)} device records",
              flush=True)


def batch_ab(parent_latrd, parent_symv, new_latrd, new_symv, dev):
    """K2, K3 and K4 on one problem: the kernels before the batch axis and
    this tree's (whose unbatched launches run kernel instances of their
    own), in turns, with whether they give the same bits."""
    from chip_smoke import _cold_ms

    V, I = ctypes.c_void_p, ctypes.c_int
    parent_latrd.latrd_panel_planar_launch.argtypes = [V, V, I, I, I, I, V, V, V, V]
    new_latrd.latrd_panel_planar_launch.argtypes = [V, V, I, ctypes.c_longlong, I, I, I, V, V,
                                                    V, I, V]
    for lib in (parent_latrd, new_latrd):
        lib.latrd_panel_planar_launch.restype = ctypes.c_int
        lib.latrd_panel_scratch_floats.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(15)
    stream = torch.cuda.current_stream().cuda_stream
    for mb in (4096, 2048, 1024):
        t = torch.randn((2, mb, mb), generator=gen, device=dev)
        ar, ai = (t[0] + t[0].T) / 2, (t[1] - t[1].T) / 2
        del t

        def panel(lib, batched):
            pan = torch.empty((6, 32, mb), device=dev)
            scal = torch.empty((4, 32), device=dev)
            scr = torch.empty((lib.latrd_panel_scratch_floats(mb),), device=dev)
            extra = ((0,), (1,)) if batched else ((), ())
            kernel_guard.check(lib.latrd_panel_planar_launch(
                ar.data_ptr(), ai.data_ptr(), mb, *extra[0], mb, mb, 32, pan.data_ptr(),
                scal.data_ptr(), scr.data_ptr(), *extra[1], stream), "K2 A/B launch")
            return pan, scal

        parent = lambda: panel(parent_latrd, False)  # noqa: E731
        new = lambda: panel(new_latrd, True)  # noqa: E731
        same = all(torch.equal(x, y) for x, y in zip(parent(), new()))
        print(f"K2 mb=pe={mb}, one problem: same bits {same}", flush=True)
        _turns("  parent (no batch axis)", parent, "new (batch 1)", new, iters=10)
        del ar, ai
    _mv_entries(parent_symv, "one_launch")
    _mv_entries(new_symv, "batched")
    n = 4096
    t = torch.randn((2, n, n), generator=gen, device=dev, dtype=torch.float64)
    a64, ai = (t[0] + t[0].T) / 2, ((t[1] - t[1].T) / 2).float()
    del t
    v64, vi = torch.randn((2, n), generator=gen, device=dev, dtype=torch.float64)
    a32, v32, vi = a64.float(), v64.float(), vi.float()
    for label, mats, vecs in (("K4 fp32", (a32,), (v32,)), ("K4 fp64", (a64,), (v64,)),
                              ("K3", (a32, ai), (v32, vi))):
        parent, new = _mv_call(parent_symv, mats, vecs, n), _mv_call(new_symv, mats, vecs, n)
        print(f"{label} n={n}, one problem: same bits {torch.equal(parent(), new())}",
              flush=True)
        _turns("  warm: parent (no batch axis)", parent, "new (batch 1)", new, iters=100)
        cold = [_cold_ms(torch, f) for f in (parent, new, new, parent)]
        print(f"  cold: parent {cold[0]:.4f}, {cold[3]:.4f} ms; new {cold[1]:.4f}, "
              f"{cold[2]:.4f} ms", flush=True)


def main():
    args = sys.argv[1:]
    mode = {"--symv": "symv", "--batch": "batch"}.get(args[0] if args else "", "k2k9")
    args = args[1:] if mode != "k2k9" else args
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    parent_dir = pathlib.Path(args[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    parent_csrc = parent_dir / "eigensolver_gpu_torch" / "csrc"
    _check_parent(parent_csrc, mode)
    csrc = kernel_guard.CSRC
    dev = torch.device("cuda")
    if mode == "symv":
        jobs = [(parent_csrc / "symv.cu", "parent_symv"), (csrc / "symv.cu", "new_symv")]
    elif mode == "batch":
        jobs = [(parent_csrc / "latrd_panel.cu", "parent_latrd_b"),
                (parent_csrc / "symv.cu", "parent_symv_b"),
                (csrc / "latrd_panel.cu", "new_latrd"), (csrc / "symv.cu", "new_symv")]
    else:
        jobs = [(parent_csrc / "latrd_panel.cu", "parent_latrd"),
                (parent_csrc / "replay.cu", "parent_replay"),
                (csrc / "latrd_panel.cu", "new_latrd"), (csrc / "replay.cu", "new_replay")]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: _build(*j), jobs))
    if mode == "symv":
        mv_ab(libs[0], libs[1], dev)
        k4_solve(libs[0], dev)
    elif mode == "batch":
        batch_ab(*libs, dev)
    else:
        k2(libs[0], libs[2], dev)
        k9(parent_dir, libs[1], libs[3], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
