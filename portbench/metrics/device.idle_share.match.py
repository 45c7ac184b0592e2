"""Share of the traced window in which no operation ran on the device,
in %: 1 - merged busy time / window, from the light trace (the device's
activity alone, portbench/trace.measure), whose cost on the host is the
smallest the profiler has; PERF.md gives that cost against the untraced
stretch."""


def read(s):
    if not s.get("window_s") or not s.get("busy_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
