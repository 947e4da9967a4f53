"""Completed invocations over the time they took: call to outputs written
back, every stall inside an invocation included."""


def read(rec):
    invs = [r for r in rec["invocations"] if r["ok"]]
    return len(invs) / rec["window_s"] if invs else None
