"""Share of the window (the invocations' summed time) in which the device
ran no sweep graph: 1 - device time in the sweep graphs / window.  The few
copies outside the graphs count as idle, so it reads slightly high."""


def read(rec):
    if not rec["graph_device_s"]:
        return None
    return (1.0 - rec["graph_device_s"] / rec["window_s"]) * 100.0
