"""driver_other_ms: mean ms of a traced call outside the named stages: the Cholesky,
the solves to standard form, the upper solve and the glue of the drivers."""

from port_bench.stages import RANGES, call_stage_s, mean_ms

NAMED = tuple(name for names in RANGES.values() for name in names)


def read(rec):
    return mean_ms(rec, lambda c: c["seconds"] - call_stage_s(c, NAMED))
