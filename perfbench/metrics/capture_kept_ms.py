"""Mean host ms an invocation spends capturing the bodies its sweep graph
holds (span ``capture.kept`` inside ``capture``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/capture/capture.kept")
