"""stedc_ms: mean ms a traced call spends in the stedc range."""

from port_bench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "stedc")
