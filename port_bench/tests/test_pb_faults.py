"""The check against broken timed paths, on the CPU at a small size.

Each run skips the look for a card and drives the rest of a run of a cell at
n = 128 with the cell's own limits. The program comes out correct; its control
(the reference in fp32 in its place) and each fault the cell can have come out
not correct: a call that returns its state unchanged, half of a batch left out,
an answer altered where it is produced. One card, so no exchange between cards.
"""

import time

import pytest
import torch

from port_bench import control, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(name):
    cell = spec.cell(name)
    wl = cell.workload
    cell.workload = dict(wl, n=128, iu=min(wl["iu"], 16), batch=4 if wl["batch"] > 1 else 1,
                         pool=2)
    return cell


def run(cell, entry=None):
    result, rows = harness.run_cell(cell, 2**31 + 3, 0.01, False, "cpu", time.perf_counter(),
                                    entry=entry)
    return result


def unchanged(kind):
    """The call hands back its starting state: the diagonal, unit vectors."""

    def solve(*problem, il=1, iu=None, cfg=None):
        a = problem[0]
        w = torch.diagonal(a, dim1=-2, dim2=-1)[..., il - 1 : iu].clone()
        z = torch.eye(a.shape[-1], dtype=a.dtype).expand(a.shape)[..., il - 1 : iu].clone()
        info = torch.zeros(a.shape[:-2], dtype=torch.int32)
        return (w, z, torch.zeros_like(z), info) if kind == "planar" else (w, z, info)

    return solve


def half_batch(entry):
    """Only the first half of the batch is solved; the rest repeats it."""

    def solve(*problem, **kw):
        half = problem[0].shape[0] // 2
        out = entry(*(t[:half] for t in problem), **kw)
        return tuple(torch.cat([t, t]) for t in out)

    return solve


def altered(entry):
    """One eigenvalue altered where it is produced, by 1e-7 of its size."""

    def solve(*problem, **kw):
        out = tuple(entry(*problem, **kw))
        w = out[0].clone()
        w[..., -1] *= 1 + 1e-7
        return (w, *out[1:])

    return solve


@pytest.mark.parametrize("name", CELLS)
def test_program_correct_control_not(name):
    cell = small(name)
    assert run(cell)["correct"] is True
    result = run(cell, control.entry(cell.config["input"]))
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_faults_not_correct(name):
    cell = small(name)
    kind = cell.config["input"]
    program = harness.resolve(cell.config["entries"]["batched" if cell.workload["batch"] > 1
                                                      else "single"])
    faults = {"unchanged": unchanged(kind), "altered": altered(program)}
    if cell.workload["batch"] > 1:
        faults["half_batch"] = half_batch(program)
    for fault, entry in faults.items():
        result = run(cell, entry)
        assert result["correct"] is False, fault
        assert result["failed"] >= 1, fault
