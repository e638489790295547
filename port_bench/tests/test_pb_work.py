"""work.py: the schedule's window count and Q2's elements against a brute-force
walk of the sweeps, and counts read from the stated shapes alone."""

import dataclasses
import json

import pytest

from port_bench import spec, work


def brute_windows(n, b):
    """Walk the band-to-tridiagonal sweeps: sweep j reduces column j, and its
    windows start at rows j + 1, j + 1 + b, ... while a window holds at least
    two rows; a window's reflector spans min(b, n - row) rows."""
    windows = elements = 0
    for j in range(n - 2):
        r = j + 1
        while r <= n - 2:
            windows += 1
            elements += min(b, n - r)
            r += b
    return windows, elements


@pytest.mark.parametrize("n,b", [(3, 2), (4, 2), (10, 2), (20, 3), (33, 4), (64, 8), (100, 6),
                                 (128, 16), (130, 32), (200, 32)])
def test_counts_match_brute_force(n, b):
    windows, elements = brute_windows(n, b)
    assert work.chase_windows(n, b) == windows
    assert work.reflector_elements(n, b) == elements


def test_known_window_count():
    # the chase's count at the planar cell's shape (PERF.md's kernel table, K7 and K8)
    assert work.chase_windows(4096, 32) == 263936


def _cells():
    bench = spec.benchmark()
    return [spec.cell(w["name"]) for w in bench["workloads"]]


@pytest.mark.parametrize("kernel", ["chase", "replay"])
def test_counts_positive_and_only_band_matters(kernel):
    from eigensolver_gpu_torch.utils.config import SolverConfig

    other = {"nb_tridiag": 64, "nb_back": 64, "stedc_leaf": 32, "replay_g": 8,
             "refine_iters": 3, "use_pallas": True, "mosaic_kernels": False,
             "two_stage_min_n": 1024, "refine_margin": 16}
    assert set(other) <= {f.name for f in dataclasses.fields(SolverConfig)}
    for cell in _cells():
        base = work.kernel_seconds(kernel, cell.workload, cell.config)
        assert base > 0
        for key, value in other.items():
            cfg = json.loads(json.dumps(cell.config))
            cfg["solver"][key] = value
            assert work.kernel_seconds(kernel, cell.workload, cfg) == base
        wider = dict(cell.config, band=16)
        assert work.kernel_seconds(kernel, cell.workload, wider) != base


@pytest.mark.parametrize("complex_", [False, True])
def test_work_scales(complex_):
    f1, b1 = work.chase_work(512, 32, "float32", complex_)
    f2, b2 = work.chase_work(512, 32, "float32", complex_, batch=8)
    assert (f2, b2) == (8 * f1, 8 * b1)
    r1, _ = work.replay_work(512, 32, 64, "float64", complex_)
    r2, _ = work.replay_work(512, 32, 128, "float64", complex_)
    assert r2 == 2 * r1 > 0
    assert work.least_seconds(f1, b1, "float32") >= f1 / work.CEILINGS["f32"]


def test_frozen_ceilings():
    assert work.CEILINGS == {"bf16": 989e12, "f32": 67e12, "f64": 67e12, "hbm": 3.35e12}
