"""solve_ms_p90: the 90th percentile by nearest rank of every call time of the window, in ms."""

import math


def read(rec):
    ordered = sorted(rec["calls_s"])
    return 1e3 * ordered[max(math.ceil(0.9 * len(ordered)) - 1, 0)]
