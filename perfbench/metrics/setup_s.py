"""Process start to the first timed invocation: start-up, the builder,
the input sets, the warm invocations (and, in a checkout's first run, the
build of the port's kernels)."""


def read(rec):
    return rec["setup_s"]
