"""Sweep-graph replays over the sweeps the runs needed: the replays past
the end of a run (a block is replayed whole) are the waste."""


def read(rec):
    runs = [r for r in rec["invocations"] if "n_replays" in r]
    sweeps = sum(r["n_sweeps"] for r in runs)
    return sum(r["n_replays"] for r in runs) / sweeps if sweeps else None
