"""Mean host ms an invocation spends in the relaxed capture that is thrown
away, after a synchronize (span ``capture.warm`` inside ``capture``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/capture/capture.warm")
