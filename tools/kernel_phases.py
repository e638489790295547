#!/usr/bin/env python3
"""Where the time goes inside kernels K1 (csrc/pchol_block.cu), K2
(csrc/latrd_panel.cu), K5 (csrc/ql_panel.cu), K6 (csrc/ql_panel_planar.cu),
K7 (csrc/chase.cu), K8 (csrc/chase_planar.cu), K9 (csrc/replay.cu), K10
(csrc/replay_planar.cu), K4 and K3 (csrc/symv.cu) on the card, by phase.

    python3 tools/kernel_phases.py

Builds a copy of each source into eigensolver_gpu_torch/build/phases/ in
which one thread of block 0 (thread 0; for K9 also its producer thread)
reads clock64() after every block, cluster or grid barrier, runs K1 at
nb = 128, K2 at mb = pe = 4096, K5 and K6 at the main paths' largest panel
((4096, 32), rb = 4032, fp32), K7 and K8 at n = 4096, b = 32, fp32, and K9
and K10 at n = m = 4096, b = 32, g = 96, fp32, K4 (fp32) and K3 at n = 4096
(marked by block 100), the kernels that take a batch (K1, K6, K8, K10) on
one problem, and prints, for each mark of
the source, the SM cycles spent before it summed over the run and how often
it was reached. The committed kernels carry no instrumentation; the marks
cost the marking thread a few dozen cycles each. Needs a CUDA device and
nvcc.

A mark goes after each ``__syncthreads();``, ``cluster.sync();`` or
``grid.sync();`` that begins a line of its own, and after each line that
equals one of the statements given to ``build`` (the kernel's first
statement; for K2 the end of a row's matvec, so that a column's time splits
into the matvec, the three grid barriers and the step work between them;
for K7 and K8 also the line that publishes a slot's flag, so that the time
before the barrier after the flag wait is the wait; for K9 and K10 the wait
for a chunk's copies, the refill and the FMA loop of a chunk, so that a
window's time splits into staging waits, barriers, copy issue, FMAs and
write-back; K9's copies are asked for by its producer warp, split apart:
the wait for a window's signal, the wait for a free stage, the copy issue;
for K4 and K3 the copy issue, the FMAs and the partial writes of a tile,
the grid barrier and the finishing sums, so that a tile's time splits into
staging wait, copy issue, FMAs and partial writes);
a barrier written behind an ``if`` on the same line is not marked, and its
time falls to the next mark. Each reported line is printed with its text,
so the output names what it timed whatever the source's line numbers are.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from eigensolver_gpu_torch.utils import kernel_guard  # noqa: E402

_MARKS = 1 << 17  # K7 and K8 mark about 7 a timestep, 12 280 timesteps
_HEADER = """__device__ long long g_mark_t[{marks}];
__device__ int g_mark_line[{marks}];
__device__ int g_marks;
#define MARK() do {{ if (threadIdx.x == {thread} && blockIdx.x == {block}) {{ const int n_ = g_marks++; \\
  if (n_ < {marks}) {{ g_mark_t[n_] = clock64(); g_mark_line[n_] = __LINE__; }} }} }} while (0)
extern "C" int marks_read(long long* t, int* line, int* n) {{
  cudaMemcpyFromSymbol(t, g_mark_t, sizeof(g_mark_t));
  cudaMemcpyFromSymbol(line, g_mark_line, sizeof(g_mark_line));
  return (int)cudaMemcpyFromSymbol(n, g_marks, sizeof(int));
}}
extern "C" int marks_reset() {{
  int z = 0;
  return (int)cudaMemcpyToSymbol(g_marks, &z, sizeof(int));
}}
"""


def build(name: str, *after: str, thread: str = "0", block: int = 0):
    """The instrumented library of csrc/<name>.cu, marked by ``thread`` of
    ``block`` after its barriers and after the lines equal to ``after``, and
    a map from its line numbers to the source's."""
    src = (kernel_guard.CSRC / f"{name}.cu").read_text()
    lines = src.splitlines()
    header = _HEADER.format(marks=_MARKS, thread=thread, block=block)
    out = []
    for line in lines:
        for sync in ("__syncthreads();", "cluster.sync();", "grid.sync();"):
            if line.strip().startswith(sync) or line.strip() == sync:
                line = line.replace(sync, sync + " MARK();", 1)
        if line.strip() in after:
            line += " MARK();"
        out.append(line)
    head = header.count("\n")
    at = next(i for i, line in enumerate(out) if line.startswith("#include <cuda_runtime.h>"))
    text = "\n".join(out[: at + 1]) + "\n" + header + "\n".join(out[at + 1 :]) + "\n"
    where = kernel_guard.BUILD / "phases"
    where.mkdir(parents=True, exist_ok=True)
    tag = "" if thread == "0" else "_t" + "".join(ch for ch in thread if ch.isalnum())
    tag += "" if block == 0 else f"_b{block}"
    cu, so = where / f"{name}{tag}.cu", where / f"lib{name}{tag}.so"
    cu.write_text(text)
    cmd = [kernel_guard._nvcc(), *kernel_guard.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the instrumented {name}.cu:\n{proc.stdout}")
    to_source = lambda n: n - head if n > at + 1 else n  # noqa: E731
    return ctypes.CDLL(str(so)), lines, to_source


def report(lib, lines, to_source, label):
    t = (ctypes.c_longlong * _MARKS)()
    line = (ctypes.c_int * _MARKS)()
    n = ctypes.c_int()
    lib.marks_read(t, line, ctypes.byref(n))
    k = min(n.value, _MARKS)
    print(f"{label}: {t[k - 1] - t[0]} SM cycles from the first mark to the last, {k} marks")
    per = {}
    for i in range(1, k):
        acc = per.setdefault(to_source(line[i]), [0, 0])
        acc[0] += t[i] - t[i - 1]
        acc[1] += 1
    for src_line, (cycles, count) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cycles:8d} cycles before line {src_line} ({count} times): "
              f"{lines[src_line - 1].strip()[:80]}")


def main():
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    rng = np.random.default_rng(0)

    lib, lines, to_source = build("pchol_block", "const int t = threadIdx.x;")
    fn = lib.pchol_block_planar_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    nb = 128
    g = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    a = g @ g.conj().T + nb * np.eye(nb)
    ar = torch.tensor(a.real.copy(), dtype=torch.float32, device=dev)
    ai = torch.tensor(a.imag.copy(), dtype=torch.float32, device=dev)
    out = torch.empty((4, nb, nb), device=dev)
    fail = torch.empty((), dtype=torch.int32, device=dev)
    for _ in range(2):  # the second call is the one read
        lib.marks_reset()
        status = fn(ar.data_ptr(), ai.data_ptr(), nb, 0, nb, 1,  # one block: batch 1
                    *(out[i].data_ptr() for i in range(4)), nb * nb, fail.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented pchol_block launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source, f"K1 nb={nb}")

    lib, lines, to_source = build("latrd_panel", "cg::grid_group grid = cg::this_grid();",
                                  "vec(R_UI)[i] = u.y;")
    fn = lib.latrd_panel_planar_launch
    V, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [V, V, I, ctypes.c_longlong, I, I, I, V, V, V, I, V]
    fn.restype = ctypes.c_int
    lib.latrd_panel_scratch_floats.restype = ctypes.c_int
    mb = 4096
    h = rng.standard_normal((mb, mb)) + 1j * rng.standard_normal((mb, mb))
    h = (h + h.conj().T) / 2
    hr = torch.tensor(h.real, dtype=torch.float32, device=dev)
    hi = torch.tensor(h.imag, dtype=torch.float32, device=dev)
    del h
    pan = torch.empty((6, 32, mb), device=dev)
    scal = torch.empty((4, 32), device=dev)
    scratch = torch.empty((lib.latrd_panel_scratch_floats(mb),), device=dev)
    for _ in range(2):
        lib.marks_reset()
        status = fn(hr.data_ptr(), hi.data_ptr(), mb, 0, mb, mb, 32, pan.data_ptr(),  # batch 1
                    scal.data_ptr(), scratch.data_ptr(), 1,
                    torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented latrd_panel launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source, f"K2 mb=pe={mb} nb=32 fp32 (block 0: rows 0-31)")
    del hr, hi

    lib, lines, to_source = build("ql_panel_planar", "const int tid = threadIdx.x;")
    fn = lib.ql_panel_planar_f32_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    m, b, rb = 4096, 32, 4032
    planes = torch.tensor(rng.standard_normal((2, m, m)), dtype=torch.float32, device=dev)
    pr, pi = planes[0, :, m - 64 : m - 32], planes[1, :, m - 64 : m - 32]
    new = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    outs = (new(m, b), new(m, b), new(m, b), new(m, b), new(b), new(b), new(b, b), new(b, b))
    for _ in range(2):
        lib.marks_reset()
        status = fn(pr.data_ptr(), pi.data_ptr(), pr.stride(0), 0, m, b, rb, 1,
                    *(x.data_ptr() for x in outs), torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented ql_panel_planar launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source, f"K6 ({m}, {b}) rb={rb} fp32")

    lib, lines, to_source = build("ql_panel", "const int tid = threadIdx.x;")
    fn = lib.ql_panel_f32_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    p = planes[0, :, m - 64 : m - 32]
    outs = (new(m, b), new(m, b), new(b), new(b, b))
    for _ in range(2):
        lib.marks_reset()
        status = fn(p.data_ptr(), p.stride(0), 0, m, b, rb, 1, *(x.data_ptr() for x in outs),
                    torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented ql_panel launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source, f"K5 ({m}, {b}) rb={rb} fp32")
    del planes

    lib, lines, to_source = build(
        "chase_planar", "T* smem = reinterpret_cast<T*>(smem_raw);",
        "if (threadIdx.x == 0) publish(progress + p, t + 1);")
    fn = lib.bulge_chase_planar_f32_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    n, b = 4096, 32
    band = np.zeros((2, n, 2 * b))
    band[0, :, : b + 1] = rng.standard_normal((n, b + 1))
    band[1, :, 1 : b + 1] = rng.standard_normal((n, b))
    band[:, np.arange(n)[:, None] + np.arange(2 * b)[None, :] >= n] = 0.0
    band = torch.tensor(band, dtype=torch.float32, device=dev)
    s_slots = ((n - 3) // b) // 3 + 1
    t3 = 3 * ((3 * (n - 3) + 3) // 3)
    for _ in range(2):
        work = band.clone()
        vt = torch.zeros((2, t3, s_slots, b), device=dev)
        taut = torch.zeros((2, t3, s_slots), device=dev)
        progress = torch.zeros((s_slots,), dtype=torch.int32, device=dev)
        lib.marks_reset()
        status = fn(work[0].data_ptr(), work[1].data_ptr(), n, b, 1, vt[0].data_ptr(),
                    vt[1].data_ptr(), taut[0].data_ptr(), taut[1].data_ptr(), progress.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented chase_planar launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source, f"K8 n={n} b={b} fp32 (block 0: slot 0)")

    lib, lines, to_source = build(
        "chase", "T* smem = reinterpret_cast<T*>(smem_raw);",
        "if (threadIdx.x == 0) publish(progress + p, t + 1);")
    fn = lib.bulge_chase_f32_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    band = band[0].clone()  # the real part: a symmetric band
    for _ in range(2):
        work = band.clone()
        vt = torch.zeros((t3, s_slots, b), device=dev)
        taut = torch.zeros((t3, s_slots), device=dev)
        progress = torch.zeros((s_slots,), dtype=torch.int32, device=dev)
        lib.marks_reset()
        status = fn(work.data_ptr(), n, b, 1, vt.data_ptr(), taut.data_ptr(), progress.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented chase launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source, f"K7 n={n} b={b} fp32 (block 0: slot 0)")

    from eigensolver_gpu_torch.ops.chase import bulge_chase_planar_kernel
    from eigensolver_gpu_torch.ops.replay import window_store_planar

    lib, lines, to_source = build(
        "replay_planar", "extern __shared__ __align__(1024) unsigned char smem_raw[];",
        "mbar_wait(bars + f % kStages, (f / kStages) & 1);", "issue();",
        "fma_chunk<T>(stage, ty, tx, acc_r, acc_i);")
    fn = lib.apply_q2_planar_f32_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    g, m = 96, 4096
    hb = np.zeros((2, n, 2 * b))
    hb[0, :, : b + 1] = rng.standard_normal((n, b + 1))
    hb[1, :, 1 : b + 1] = rng.standard_normal((n, b))
    hb[:, np.arange(n)[:, None] + np.arange(2 * b)[None, :] >= n] = 0.0
    hb = torch.tensor(hb, dtype=torch.float32, device=dev)
    _, _, vt, taut = bulge_chase_planar_kernel(hb[0], hb[1], b)
    store, table = window_store_planar(vt, taut, n, b, g)
    row0 = torch.from_numpy(table["row0"].astype(np.int32)).to(dev)
    y = torch.tensor(rng.standard_normal((2, n, m)), dtype=torch.float32, device=dev)
    for _ in range(2):
        lib.marks_reset()
        status = fn(store[0].data_ptr(), store[1].data_ptr(), row0.data_ptr(), row0.numel(),
                    y[0].data_ptr(), y[1].data_ptr(), m, n, m, table["geo"]["l_win"], 1,
                    torch.cuda.current_stream().cuda_stream)
        kernel_guard.check(status, "instrumented replay_planar launch")
        torch.cuda.synchronize()
    report(lib, lines, to_source,
           f"K10 n={n} m={m} b={b} g={g} fp32 (block 0: columns 0-31, {row0.numel()} windows)")

    from eigensolver_gpu_torch.ops.chase import bulge_chase_kernel
    from eigensolver_gpu_torch.ops.replay import window_store

    _, _, vt, taut = bulge_chase_kernel(hb[0].clone(), b)
    store, table = window_store(vt, taut, n, b, g)
    row0 = torch.from_numpy(table["row0"].astype(np.int32)).to(dev)
    y = y[0].clone()
    consumer = ("if (!meets && v + 1 < n_win) mbar_arrive(sig);", "consumers_sync();",
                "mbar_wait(full + st, (f / kStages) & 1);", "fma_chunk<T>(stage, ty, tx, acc);",
                "if (lane == 0) mbar_arrive(empty + st);",
                "r_after = v + 2 < n_win ? row0[v + 2] : 0;")
    producer = ("if (w > 0) mbar_wait(sig, (w - 1) & 1);",
                "if (use > 0) mbar_wait(empty + st, (use - 1) & 1);",
                "tma_load(stage + S::kQ, &maps.y, col0, r_cur + c * S::kKC, item, full + st);")
    for thread, after, who in (("0", consumer, "consumer thread 0"),
                               ("kConsumers", producer, "the producer thread")):
        lib, lines, to_source = build(
            "replay", "extern __shared__ __align__(1024) unsigned char smem_raw[];", *after,
            thread=thread)
        fn = lib.apply_q2_f32_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for _ in range(2):
            lib.marks_reset()
            status = fn(store.data_ptr(), row0.data_ptr(), row0.numel(), y.data_ptr(), m, n, m,
                        table["geo"]["l_win"], 1, torch.cuda.current_stream().cuda_stream)
            kernel_guard.check(status, "instrumented replay launch")
            torch.cuda.synchronize()
        report(lib, lines, to_source,
               f"K9 n={n} m={m} b={b} g={g} fp32 (block 0: columns 0-31, {who}, "
               f"{row0.numel()} windows)")

    # K4 and K3: block 100 (of 264 at n = 4096), whose tiles lie
    # inside column strips; the marks split a tile into the staging wait
    # (with the barrier), the copy issue, the FMAs and the partial writes,
    # then the grid barrier's wait and the finishing sums
    lib, lines, to_source = build(
        "symv", "T* red = smem + C::kStages * C::kStageElems;", "cp_async_commit();",
        "tile_products<T, P>(smem + (k % C::kStages) * C::kStageElems, tx, ty, s, acc);",
        "if (++ci > cj) ++cj, ci = 0;", "cg::this_grid().sync();",
        "finish<T, P, kBatched>(g, red);", block=100)
    V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.symv_part_elems.argtypes = [I, I]
    lib.symv_part_elems.restype = ctypes.c_longlong
    lib.symv_f32_launch.argtypes = [V, I, L, I, V, L, V, V, I, V]
    lib.hemv_planar_launch.argtypes = [V, V, I, L, I, V, V, L, V, V, I, V]
    n = 4096
    t = torch.tensor(rng.standard_normal((2, n, n)), dtype=torch.float32, device=dev)
    vv = torch.tensor(rng.standard_normal((2, n)), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for planes, label in ((1, f"K4 n={n} fp32"), (2, f"K3 n={n}")):
        part = torch.empty(lib.symv_part_elems(n, planes), device=dev)
        y = torch.empty(planes * n, device=dev)
        for _ in range(2):
            lib.marks_reset()
            if planes == 1:  # one problem: batch 1
                status = lib.symv_f32_launch(t[0].data_ptr(), n, 0, n, vv[0].data_ptr(), n,
                                             part.data_ptr(), y.data_ptr(), 1, stream)
            else:
                status = lib.hemv_planar_launch(t[0].data_ptr(), t[1].data_ptr(), n, 0, n,
                                                vv[0].data_ptr(), vv[1].data_ptr(), n,
                                                part.data_ptr(), y.data_ptr(), 1, stream)
            kernel_guard.check(status, "instrumented symv launch")
            torch.cuda.synchronize()
        report(lib, lines, to_source, f"{label} (block 100, thread 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
