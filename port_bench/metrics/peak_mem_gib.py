"""peak_mem_gib: the most device memory a call of the window allocated above what
was allocated when it began (the pool, the kept outputs): the solver's own peak."""


def read(rec):
    peaks = rec["call_peaks"]
    return max(peaks) / 2**30 if peaks else None
