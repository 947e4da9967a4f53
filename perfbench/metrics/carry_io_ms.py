"""Mean host ms an invocation spends outside the capture and the loop in
the program's run: the carry built from the mmaps, the results read back
and written into the mmaps (``program_s - capture_s - loop_s``)."""


def read(rec):
    runs = [r for r in rec["invocations"] if "program_s" in r]
    if not runs:
        return None
    return sum(r["program_s"] - r["capture_s"] - r["loop_s"]
               for r in runs) / len(runs) * 1e3
