"""solve_ms: the window's wall time over the calls completed in it, in ms."""


def read(rec):
    return 1e3 * rec["window_s"] / len(rec["calls_s"])
