"""Stage times of the traced calls, from the program's synchronising ranges.

Each call of the traced window's synchronising part records ``(name, seconds)``
for every ``utils/tracing.py`` range it ran; a stage is the sum of its ranges in
a call, and a metric the mean over the calls. The ranges summed here never nest
in one another.
"""

from __future__ import annotations

RANGES = {
    "band_reduce": ("psbrd", "sbrd"),
    "bulge_chase": ("bulge_chase_planar", "bulge_chase"),
    "stedc": ("stedc",),
    "back_transform": ("apply_q2_planar_qs", "apply_q2_planar", "apply_q1_planar",
                       "apply_q2_qs", "apply_q2", "apply_q1"),
    "refine": ("refine_gevp_planar", "refine_gevp"),
}


def call_stage_s(call, names):
    return sum(s for name, s in call["ranges"] if name in names)


def mean_ms(rec, per_call):
    """Mean over the traced calls of ``per_call(call)`` seconds, in ms; None
    without traced calls."""
    calls = rec["staged"]
    if not calls:
        return None
    return 1e3 * sum(per_call(c) for c in calls) / len(calls)


def stage_ms(rec, stage):
    """Mean ms a call of the stage's ranges; None where no call ran one."""
    names = RANGES[stage]
    if not any(name in names for c in rec["staged"] for name, _ in c["ranges"]):
        return None
    return mean_ms(rec, lambda c: call_stage_s(c, names))
