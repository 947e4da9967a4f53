"""Ring-kernel launches (``ring_pop``, ``ring_push``, ``sweep_guards``,
``service_ports``; each kernel counts itself on the card) over the
window's sweeps."""


def read(rec):
    runs = [r for r in rec["invocations"] if "n_sweeps" in r]
    sweeps = sum(r["n_sweeps"] for r in runs)
    if rec["launches"] is None or not sweeps:
        return None
    return rec["launches"] / sweeps
