"""setup_s: seconds from the start of the process to the first timed call: imports,
the CUDA context, loading (or building) the kernels, the inputs, the warm-up call."""


def read(rec):
    return rec["setup_s"]
