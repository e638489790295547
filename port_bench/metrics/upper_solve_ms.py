"""upper_solve_ms: mean ms a traced call spends in the span back_solve, phase 4's solve
x = L^{-H} y (x = U^{-1} y on the real cells)."""

from port_bench.spans import span_ms


def read(rec):
    return span_ms(rec, "back_solve")
