"""The program's own trace of each invocation of the window, for the
readers of the per-layer metrics that the record does not carry
(``metrics/elaborate_ms.py`` and the others beside it).

``CompiledEngine`` records one trace a run (``repro_torch.core.trace``) and
keeps the summary of the last ones in ``trace.RECENT``: ``spans`` (path ->
host seconds) and ``counters``.  A window invocation's summary is the one
whose ``lower``, ``capture`` and ``loop`` seconds equal its record's, which
the engine reads from the same spans.  A program without the trace, or a
run whose invocations the port did not make, gives no summary, and the
readers read nothing.
"""


def window(rec) -> list:
    """The summaries of the window's invocations, in the record's order;
    empty where any invocation has none."""
    try:
        from repro_torch.core.trace import RECENT
    except ImportError:
        return []
    by_key = {}
    for s in RECENT:
        sp = s["spans"]
        by_key[(sp.get("invoke/lower", 0.0), sp.get("invoke/capture", 0.0),
                sp.get("invoke/loop", 0.0))] = s
    runs = [r for r in rec["invocations"] if "lower_s" in r]
    out = [by_key.get((r["lower_s"], r["capture_s"], r["loop_s"]))
           for r in runs]
    return out if out and all(s is not None for s in out) else []


def mean_span_ms(rec, path: str):
    """Mean host ms an invocation spends in the span at ``path``."""
    runs = window(rec)
    if not runs or not all(path in s["spans"] for s in runs):
        return None
    return sum(s["spans"][path] for s in runs) / len(runs) * 1e3


def mean_counter(rec, name: str):
    """Mean of the counter ``name`` over the invocations."""
    runs = window(rec)
    if not runs or not all(name in s["counters"] for s in runs):
        return None
    return sum(s["counters"][name] for s in runs) / len(runs)
