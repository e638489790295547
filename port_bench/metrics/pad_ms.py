"""pad_ms: mean ms a traced call spends in the span pad_pencil: the planar driver's padding of
a pencil whose n is past 128 and not a multiple of it (identity in B, zeros in A), and the
raising of the padded block of its tridiagonal matrix above the spectrum before stedc."""

from port_bench.spans import span_ms


def read(rec):
    return span_ms(rec, "pad_pencil")
