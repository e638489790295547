"""chase_roofline: the chase kernel's least time by work.py over its kineto time
a call (K8 chase_planar_kernel on planar cells, K7 chase_kernel on real ones)."""

from port_bench.kernels import roofline_pct


def read(rec):
    return roofline_pct(rec, "chase")
