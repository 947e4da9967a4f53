"""Device us a replay of the sweep's CUDA graph: CUDA events around each
block of replays, summed, over the replays."""


def read(rec):
    if not rec["graph_device_s"] or not rec["replays_timed"]:
        return None
    return rec["graph_device_s"] / rec["replays_timed"] * 1e6
