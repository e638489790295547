"""replay_roofline: the replay kernel's least time by work.py (Q2 applied to
the m selected columns) over its kineto time a call (K10 on planar cells, K9 on real ones)."""

from port_bench.kernels import roofline_pct


def read(rec):
    return roofline_pct(rec, "replay")
