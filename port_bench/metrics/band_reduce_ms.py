"""band_reduce_ms: mean ms a traced call spends in the ranges psbrd (planar) or sbrd (real)."""

from port_bench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "band_reduce")
