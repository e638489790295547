"""pad_rows: rows the planar driver adds to a pencil whose n is not a multiple of 128 (the
pad.rows counter, once a padded solve; a batch shares them), per traced call. None where
no call padded: an aligned n, or a program without the counter."""

from port_bench.spans import count_per_call


def read(rec):
    return count_per_call(rec, "pad.rows") or None
