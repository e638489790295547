"""Readings that a cell's limits are set from: the program's and its control's.

    python3 port_bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed S] [--out FILE]

For each seed the input generator makes the cell's pool at the cell's own size,
the program's entry solves each problem of it once (as the window's calls do,
after one warm-up call) and ``check.py`` reads eig_err, residual and b_orth of
each against the reference; then the control (``control.py``: the reference in
fp32) does the same on the first ``--control-seeds`` seeds. Prints one JSON
line a seed and side, and writes them all to ``--out``. Needs the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(torch, cell, entry, seed):
    """Worst eig_err, residual, b_orth and info over one seed's pool."""
    from eigensolver_gpu_torch.utils.config import SolverConfig

    from port_bench import check, spec

    wl, cfg = cell.workload, cell.config
    kind, batched = cfg["input"], wl["batch"] > 1
    pool = spec.module("inputs", wl["inputs"]).make(wl["n"], wl["batch"], wl["pool"], seed,
                                                    "cuda")
    solver = SolverConfig(**cfg["solver"])
    info_bad = 0.0

    def calls():
        nonlocal info_bad
        for p, problem in enumerate(pool):
            out = tuple(entry(*problem, il=wl["il"], iu=wl["iu"], cfg=solver))
            torch.cuda.synchronize()
            info_bad += float((out[-1] != 0).sum())
            yield p, p, out
            del out

    got, _ = check.worst(kind, pool, calls(), wl["il"], wl["iu"], batched, wl["limits"])
    return {"info_bad": info_bad, **got}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import control, harness, spec

    if not torch.cuda.is_available():
        harness.log("calibrate.py needs a CUDA device")
        return 2
    cell = spec.cell(args.workload)
    harness.build(cell.config["build"])
    program = harness.resolve(cell.config["entries"]["batched" if cell.workload["batch"] > 1
                                                     else "single"])
    lines = []
    sides = [("program", program, args.seeds),
             ("control", control.entry(cell.config["input"]), args.control_seeds)]
    for side, entry, count in sides:
        for k in range(count):
            seed = args.first_seed + 7919 * k
            t0 = time.perf_counter()
            got = readings(torch, cell, entry, seed)
            line = {"workload": args.workload, "side": side, "seed": seed, **got,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
