"""On the card: the control at each cell's own size fails the cell's limits and the
program passes them (``python -m pytest port_bench/tests -m cuda``)."""

import pytest

from port_bench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes_at_cell_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from port_bench import calibrate, check, control, harness

    cell = spec.cell(name)
    harness.build(cell.config["build"])
    limits = cell.workload["limits"]
    program = harness.resolve(cell.config["entries"]["batched" if cell.workload["batch"] > 1
                                                      else "single"])
    assert check.judge(calibrate.readings(torch, cell, program, 2**31 + 1), limits)[0]
    for seed in (2**31 + 3, 2**31 + 5, 2**31 + 7):
        got = calibrate.readings(torch, cell, control.entry(cell.config["input"]), seed)
        assert not check.judge(got, limits)[0], got
