"""Frozen ceilings and the work of the kernels whose roofline shares the benchmark reads.

Every count is a function of a cell's stated shapes alone: n, the band b, the
selected columns m = iu - il + 1, the batch and the compute type. None reads
the program's window geometry or storage, so a count stays the same whatever
implements the step.

The ceilings are the published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its
full power limit of 700 W, dense, from NVIDIA's data sheet. They are a frozen
copy, kept here so that no change to the program moves the yardstick.
"""

from __future__ import annotations

CEILINGS = {
    "bf16": 989e12,  # FLOP/s, tensor cores
    "f32": 67e12,  # FLOP/s, outside the tensor cores
    "f64": 67e12,  # FLOP/s, fp64 tensor cores
    "hbm": 3.35e12,  # B/s
}

ITEMSIZE = {"float32": 4, "float64": 8}
PREC = {"float32": "f32", "float64": "f64"}


def chase_windows(n, b):
    """Windows of the standard band-to-tridiagonal schedule: sweep j takes
    column j, and its windows start at rows j + 1, j + 1 + b, ... while a
    window holds at least two rows. Counted by the chase's timestep wave
    (three timesteps a sweep, one window a slot), as a brute-force walk of
    the sweeps counts them (the tests hold the two together)."""
    s_slots = max((n - 3) // b, 0) // 3 + 1
    t_total = 3 * (n - 3) + 1 if n > 3 else 1
    windows = 0
    for t in range(t_total):
        vmax, k0 = divmod(t, 3)
        room = n - 3 - vmax - k0 * b
        if room >= 0:
            s_hi = min(room // (3 * b - 1), vmax, s_slots - 1)
            windows += max(0, s_hi - max(vmax - (n - 3), 0) + 1)
    return windows


def reflector_elements(n, b):
    """Householder elements of Q2: each window's reflector has min(b, rows
    left) elements."""
    total = 0
    for j in range(n - 2):
        starts = (n - 2 - (j + 1)) // b + 1  # windows of sweep j
        last = j + 1 + (starts - 1) * b
        total += (starts - 1) * b + min(b, n - last)
    return total


def chase_work(n, b, dtype, complex_, batch=1):
    """(flops, bytes) of chasing a band of half-width b to tridiagonal: per
    window its reflector, three b x b products and the tile updates, 12 b^2 +
    8 b real operations (four times that in complex arithmetic); the lower
    band read once, d, e and the reflectors with their taus written once."""
    planes = 2 if complex_ else 1
    windows = chase_windows(n, b)
    flops = windows * (12 * b * b + 8 * b) * (4 if complex_ else 1) * batch
    values = planes * (n * (b + 1) + (n - 1) + reflector_elements(n, b) + windows) + n
    return flops, values * ITEMSIZE[dtype] * batch


def replay_work(n, b, m, dtype, complex_, batch=1):
    """(flops, bytes) of applying Q2 to the m selected columns: each
    Householder element costs a multiply-add in v^H y and one in the update,
    4 real operations a column (16 in complex arithmetic); the reflectors
    with their taus read once, the m columns read once and written once."""
    planes = 2 if complex_ else 1
    elements = reflector_elements(n, b)
    flops = 4 * elements * m * (4 if complex_ else 1) * batch
    values = planes * (elements + chase_windows(n, b) + 2 * n * m)
    return flops, values * ITEMSIZE[dtype] * batch


def least_seconds(flops, nbytes, dtype):
    """The least time the card could take: operations at the compute peak of
    the type, or bytes at the HBM peak, whichever is longer."""
    return max(flops / CEILINGS[PREC[dtype]], nbytes / CEILINGS["hbm"])


def cell_shapes(cell, config):
    """The shapes a cell states, as the counts read them."""
    solver = config["solver"]
    dtype = solver.get("compute_dtype") or config["input_dtype"]
    return {
        "n": cell["n"],
        "b": config["band"],
        "m": cell["iu"] - cell["il"] + 1,
        "batch": cell["batch"],
        "dtype": dtype,
        "complex_": config["input"] == "planar",
    }


def kernel_seconds(kernel, cell, config):
    """Least seconds of one call's ``kernel`` ('chase' or 'replay')."""
    s = cell_shapes(cell, config)
    if kernel == "chase":
        work = chase_work(s["n"], s["b"], s["dtype"], s["complex_"], s["batch"])
    elif kernel == "replay":
        work = replay_work(s["n"], s["b"], s["m"], s["dtype"], s["complex_"], s["batch"])
    else:
        raise ValueError(f"no work count for kernel {kernel!r}")
    return least_seconds(*work, s["dtype"])
