"""Mean host ms an invocation spends in the sweep loop
(``CompiledEngine.loop_s``: the first replay to the last read of the done
flag)."""


def read(rec):
    runs = [r for r in rec["invocations"] if "loop_s" in r]
    return sum(r["loop_s"] for r in runs) / len(runs) * 1e3 if runs \
        else None
