"""stedc_sweeps: secular sweeps a merge of stedc runs, the mean over a traced call's
merges (stedc.sweeps), then over the calls."""


def read(rec):
    means = [sum(c["sweeps"]) / len(c["sweeps"]) for c in rec["staged"] if c["sweeps"]]
    return sum(means) / len(means) if means else None
