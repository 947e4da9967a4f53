"""Mean host ms an invocation spends writing the results back into the
mmaps' and ports' buffers and filling the report (span ``writeback``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/writeback")
