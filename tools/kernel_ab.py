#!/usr/bin/env python3
"""Kernels K2 (csrc/latrd_panel.cu) and K9 (csrc/replay.cu) of this tree
against their first designs, timed in turns in one process on one card.

    git archive <commit> | tar -x -C <dir>       # any directory
    python3 tools/kernel_ab.py <dir>

<dir> holds a checkout whose K2 is 65 launches a panel and whose K9 is one
launch a wave over every slot of the JAX window layout, with the C entries
in PARENT_ENTRIES (commit b9bcfb8 has them); the tool reads those entries
from <dir>'s sources and refuses a checkout whose entries differ. Builds
<dir>/eigensolver_gpu_torch/csrc/{latrd_panel,replay}.cu and this tree's
sources, each into its own library under eigensolver_gpu_torch/build/ab/.
Then, on the same inputs:

  K2 -- one panel at mb = pe = 4096, 2048 and 1024 (contiguous planes):
        the parent's and this tree's kernel in turns (parent, new, new,
        parent), CUDA-event ms of each turn, kernel launches a call by the
        profiler, and the largest difference between the two outputs
        relative to the parent's;
  K9 -- n = m = 4096, b = 32, g = 96, fp32: the window passes (the
        parent's all-slots ``window_qs``, imported from <dir>, and this
        tree's ``window_store``) and the bare kernels on their prepared
        windows, in turns, with kernel launches a call by the profiler and
        whether the two kernels give the same bits; then 20 calls of
        this tree's kernel on the same inputs, fp32 (g = 96) and fp64
        (g = b), and how many give other bits than the first.

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

# the C entries of the first designs that this tool calls, as declared
PARENT_ENTRIES = {
    "latrd_panel.cu": "latrd_panel_planar_launch(const float* ar, const float* ai, int lda, "
                      "int mb, int pe, int nb, float* pan, float* scal, float* y, void* stream)",
    "replay.cu": "apply_q2_f32_launch(const float* qw, float* y, int ldy, int n, int m, int b, "
                 "int g, int n_waves, int n_slots, void* stream)",
}


def _check_parent(csrc: pathlib.Path):
    """Raise unless <dir>'s sources declare PARENT_ENTRIES as they are."""
    for name, want in PARENT_ENTRIES.items():
        text = " ".join((csrc / name).read_text().split())
        fn = want[: want.index("(")]
        at = text.find(f'extern "C" int {fn}(')
        got = text[at + len('extern "C" int '): text.index(")", at) + 1] if at >= 0 else None
        if got != want:
            raise SystemExit(f"kernel_ab: {csrc / name} declares {got!r}, not {want!r}: "
                             "this tool calls only the first designs' C entries")


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
    for lib in (parent_lib, new_lib):
        fn = lib.latrd_panel_planar_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
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
            kernel_guard.check(new_lib.latrd_panel_planar_launch(
                ar.data_ptr(), ai.data_ptr(), mb, mb, mb, nb, pan.data_ptr(), scal.data_ptr(),
                scr.data_ptr(), stream), "K2")
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
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def new():
        y.copy_(y0)
        kernel_guard.check(fn(store.data_ptr(), row0.data_ptr(), row0.numel(), y.data_ptr(),
                              m, n, m, l_win, stream), "K9")
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
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        outs = []
        for _ in range(calls):
            y = torch.tensor(y0, dtype=dtype, device=dev)
            kernel_guard.check(fn(store.data_ptr(), row0.data_ptr(), row0.numel(), y.data_ptr(),
                                  m, n, m, table["geo"]["l_win"],
                                  torch.cuda.current_stream().cuda_stream), "K9")
            outs.append(y)
        torch.cuda.synchronize()
        differ = sum(not torch.equal(x, outs[0]) for x in outs[1:])
        print(f"K9 {str(dtype)[6:]} n={n} m={m} b={b} g={g}: {differ} of {calls - 1} repeated "
              "calls give other bits than the first", flush=True)
        del outs, store


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    parent_dir = pathlib.Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    parent_csrc = parent_dir / "eigensolver_gpu_torch" / "csrc"
    _check_parent(parent_csrc)
    csrc = kernel_guard.CSRC
    jobs = [(parent_csrc / "latrd_panel.cu", "parent_latrd"),
            (parent_csrc / "replay.cu", "parent_replay"),
            (csrc / "latrd_panel.cu", "new_latrd"), (csrc / "replay.cu", "new_replay")]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: _build(*j), jobs))
    dev = torch.device("cuda")
    k2(libs[0], libs[2], dev)
    k9(parent_dir, libs[1], libs[3], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
