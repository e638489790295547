"""bulge_chase_ms: mean ms a traced call spends in the ranges bulge_chase_planar or bulge_chase."""

from port_bench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "bulge_chase")
