"""back_transform_ms: mean ms a traced call spends in the window pass (apply_q2*_qs),
the replay of Q2 (apply_q2*) and the application of Q1 (apply_q1*)."""

from port_bench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "back_transform")
