"""Readings of the program's own spans and counters (``utils/tracing.py``).

A span: as ``stages.py`` reads its stages, from the ``(name, seconds)`` that
each call of the traced window's synchronising part records for every range
it ran; the mean over those calls of the span's seconds in a call. A
counter: from the program's ``export()`` after the window, which holds the
span records of the synchronising part (its ``enable()`` is the last) with
the counts made under each; their sum over the spans, over the calls. A
program without the span or without ``export()`` gives None.
"""

from __future__ import annotations

import importlib

from port_bench.stages import call_stage_s, mean_ms

TRACING = "eigensolver_gpu_torch.utils.tracing"


def span_ms(rec, name):
    """Mean ms a traced call spends in the span ``name``; None where no call ran it."""
    if not any(n == name for c in rec["staged"] for n, _ in c["ranges"]):
        return None
    return mean_ms(rec, lambda c: call_stage_s(c, (name,)))


def count_per_call(rec, name):
    """The counter ``name`` over the traced window's synchronising part, per call."""
    export = getattr(importlib.import_module(TRACING), "export", None)
    if export is None or not rec["staged"]:
        return None
    return sum(s["counts"].get(name, 0) for s in export()) / len(rec["staged"])
