"""Mean host ms an invocation spends elaborating and lowering the graph
(``CompiledEngine.lower_s``: the wiring bodies, the counting pass on meta
tensors, ``extract_graph`` and ``validate``)."""


def read(rec):
    runs = [r for r in rec["invocations"] if "lower_s" in r]
    return sum(r["lower_s"] for r in runs) / len(runs) * 1e3 if runs \
        else None
