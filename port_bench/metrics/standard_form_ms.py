"""standard_form_ms: mean ms a traced call spends in the span to_standard, the reduction
to C = L^{-1} A L^{-H} (planar: the two solves and the symmetrisation; real: sygst, or on
the 'trinv' route the inverse of U and its two gemms)."""

from port_bench.spans import span_ms


def read(rec):
    return span_ms(rec, "to_standard")
