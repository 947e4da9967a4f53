"""Mean host ms an invocation spends running the graph's wiring bodies
(span ``lower.elaborate`` inside ``lower``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/lower/lower.elaborate")
