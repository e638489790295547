"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the package
``eigensolver_gpu_torch``. Needs an NVIDIA GPU: without one (or with fewer cards
than the cell asks for) it prints no result and exits with 2. The last line of
standard output is one JSON object (correct, attempted, failed, metrics, device,
with ``--trace 1`` breakdown, and check last); the last lines of standard error
are the check's numbers, each beside its limit. It exits with 3, printing no
result, if JAX or the JAX package was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "eigensolver_gpu_tpu"}


def fixed_caches():
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a checkout compiles (the port builds its own kernels into
    eigensolver_gpu_torch/build/)."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def forbidden_modules():
    """JAX or the JAX package in this process, by whole top-level names."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness, spec

    cell = spec.cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, rows = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                    T_START)
    loaded = forbidden_modules()
    if loaded:
        harness.log("loaded in the benchmark's process: " + ", ".join(loaded))
        return 3
    for name, value, limit in rows:
        harness.log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
