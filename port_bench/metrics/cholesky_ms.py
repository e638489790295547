"""cholesky_ms: mean ms a traced call spends in the span potrf, the Cholesky of B (both
drivers; on the planar cells with K1)."""

from port_bench.spans import span_ms


def read(rec):
    return span_ms(rec, "potrf")
