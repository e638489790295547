"""host_syncs: synchronising CUDA operations a traced call of the synchronising part makes
under the program's spans (the host_sync counter: stedc's stop tests and bucket reads, the
refinement's escalation reads, library error checks, data-dependent shapes)."""

from port_bench.spans import count_per_call


def read(rec):
    return count_per_call(rec, "host_sync")
