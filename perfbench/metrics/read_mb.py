"""Mean MB an invocation's final read takes from the carry (counter
``read_bytes``: the counters and the written port buffers)."""

from perfbench.traces import mean_counter


def read(rec):
    n = mean_counter(rec, "read_bytes")
    return None if n is None else n / 1e6
