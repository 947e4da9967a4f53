"""Mean host ms an invocation spends building and instantiating the sweep
graph of conditional nodes (span ``capture.instantiate``)."""

from perfbench.traces import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "invoke/capture/capture.instantiate")
