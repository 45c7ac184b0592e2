"""Device ms a depth train step of the kernels launched under the program's
span train.supervision, its depth.coarse_gt and depth.fine_gt included
(portbench/program_spans.py's span_device_ms, by the innermost span open at
each launch). None where the program has no spans."""

SPANS = ("train.supervision", "depth.coarse_gt", "depth.fine_gt")


def read(s):
    ms = [s.get("span_device_ms", {}).get(k) for k in SPANS]
    if all(v is None for v in ms):
        return None
    return sum(v for v in ms if v is not None) / s["batches"]
