"""Mean host ms an invocation spends capturing the sweep's CUDA graph
(``CompiledEngine.capture_s``: the bodies' captures and the sweep graph's
assembly)."""


def read(rec):
    runs = [r for r in rec["invocations"] if "capture_s" in r]
    return sum(r["capture_s"] for r in runs) / len(runs) * 1e3 if runs \
        else None
