"""Mean host ms an invocation spends in the program's final read: the
carry's counters and the written port buffers copied to the host, one
sync (span ``read``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/read")
