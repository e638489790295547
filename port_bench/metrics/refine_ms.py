"""refine_ms: mean ms a traced call spends in the ranges refine_gevp_planar or refine_gevp."""

from port_bench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "refine")
