"""Host syncs a depth train step: every sync torch's sync debug mode
reported over the full trace's steps (the program's counter,
portbench/program_spans.py). None where the program has no spans."""


def read(s):
    n = s.get("host_syncs")
    return n / s["batches"] if n is not None else None
