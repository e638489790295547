#!/usr/bin/env python3
"""The cost of the program's tracing and where its host syncs happen, for one
benchmark cell, in one process on one card.

    python3 tools/span_cost.py --workload <cell> [--calls 6] [--seed <n>]

The cell's configuration and inputs come from ``port_bench/`` (its generator, the
first problem of the seed's pool), its kernels are loaded or built as the benchmark
builds them. After one warm-up call, ``--calls`` pairs of calls in turns: an
untraced call, then a call with tracing on as the benchmark's staged calls have it
(``utils/tracing.enable(sync=True)``: synchronizing spans and host-sync counting),
the order of the pair swapped every other pair. Each call ends in
``torch.cuda.synchronize()`` and is timed by the host's clock.

Prints one JSON line: the card and its power limit, the untraced and the traced
call ms, each span's synchronized ms a call and each span's ``host_sync`` count a
call (from ``export()``; a span's own counts, not its children's).
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--calls", type=int, default=6)
    p.add_argument("--seed", type=int, default=2**31 + 1234)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from eigensolver_gpu_torch.utils import tracing
    from eigensolver_gpu_torch.utils.config import SolverConfig
    from port_bench import harness, spec

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    cell = spec.cell(args.workload)
    wl, config = cell.workload, cell.config
    harness.build(config["build"])
    entry = harness.resolve(config["entries"]["batched" if wl["batch"] > 1 else "single"])
    (problem,) = spec.module("inputs", wl["inputs"]).make(wl["n"], wl["batch"], 1, args.seed,
                                                          "cuda")
    cfg = SolverConfig(**config["solver"])

    def call():
        t0 = time.perf_counter()
        out = entry(*problem, il=wl["il"], iu=wl["iu"], cfg=cfg)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    call()
    plain, traced = [], []
    span_ms, syncs = collections.defaultdict(float), collections.Counter()
    for k in range(args.calls):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            if not on:
                plain.append(call()[1])
                continue
            tracing.enable(sync=True)
            tracing.clear()
            try:
                traced.append(call()[1])
                for name, s in tracing.timings():
                    span_ms[name] += 1e3 * s
            finally:
                tracing.disable()
                tracing.clear()
            for s in tracing.export():
                syncs[s["name"]] += s["counts"].get(tracing.HOST_SYNC, 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    calls = args.calls
    print(json.dumps({
        "workload": args.workload, "card": card.strip(), "calls": calls,
        "untraced_ms": plain, "traced_ms": traced,
        "untraced_median_ms": statistics.median(plain),
        "traced_median_ms": statistics.median(traced),
        "span_ms": {k: v / calls for k, v in sorted(span_ms.items(), key=lambda x: -x[1])},
        "host_sync": {k: v / calls for k, v in syncs.most_common() if v},
        "host_sync_total": sum(syncs.values()) / calls,
    }), flush=True)


if __name__ == "__main__":
    main()
