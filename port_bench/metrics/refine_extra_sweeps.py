"""refine_extra_sweeps: defect-gated fp64 refinement sweeps a traced call of the synchronising
part runs (the refine_extra_sweeps counter; for a batch, sweeps of the whole batch)."""

from port_bench.spans import count_per_call


def read(rec):
    return count_per_call(rec, "refine_extra_sweeps")
