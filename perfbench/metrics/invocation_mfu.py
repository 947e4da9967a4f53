"""The least time an invocation could take on the chip, at its published
peaks, over the mean invocation time: the larger of the operations over
the float32 peak and the bytes (inputs read once, outputs written once)
over the memory bandwidth.  The work comes from ``reference/<app>.py``."""


def read(rec):
    runs = [r for r in rec["invocations"] if r["ok"]]
    if not runs:
        return None
    pk, w = rec["peaks"], rec["work"]
    least = max(w["flops"] / pk["float32_flops"],
                w["bytes"] / pk["hbm_bytes_per_s"])
    return least / (sum(r["wall_s"] for r in runs) / len(runs)) * 100.0
