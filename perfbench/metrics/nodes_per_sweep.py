"""Graph nodes a sweep ran: each captured body's nodes (torch kernels,
copies and ring kernels alike) times its phase's firings, plus the guards'
and the tail's a replay, over the window's sweeps (counters
``body_nodes_run``, ``sweep_nodes``, ``n_replays``, ``n_sweeps``)."""

from perfbench.traces import window


def read(rec):
    runs = window(rec)
    if not runs or not all("sweep_nodes" in s["counters"] for s in runs):
        return None
    c = [s["counters"] for s in runs]
    sweeps = sum(x["n_sweeps"] for x in c)
    return sum(x["body_nodes_run"] + x["sweep_nodes"] * x["n_replays"]
               for x in c) / sweeps if sweeps else None
