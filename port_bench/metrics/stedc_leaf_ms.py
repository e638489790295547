"""stedc_leaf_ms: mean ms a traced call spends in the span stedc_leaves, stedc's batched
leaf eigensolve (cuSOLVER's batched Jacobi on the fp32 leaves), inside the stedc range."""

from port_bench.spans import span_ms


def read(rec):
    return span_ms(rec, "stedc_leaves")
