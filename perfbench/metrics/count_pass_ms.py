"""Mean host ms an invocation spends in the counting pass: each (task,
phase) run once on meta tensors (span ``lower.count`` inside ``lower``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/lower/lower.count")
