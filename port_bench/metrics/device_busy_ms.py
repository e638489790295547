"""device_busy_ms: ms a profiled call keeps the device busy, the union of its kernel,
copy and set intervals; steadier than the host's clock, which the host paces."""


def read(rec):
    prof = rec["profile"]
    if not prof or not prof["busy_ns"]:
        return None
    return prof["busy_ns"] / 1e6 / prof["calls"]
