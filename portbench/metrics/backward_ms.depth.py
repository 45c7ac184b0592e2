"""Device ms a depth train step of the kernels launched under the program's
span train.backward (autograd's worker included;
portbench/program_spans.py). None where the program has no spans."""


def read(s):
    ms = s.get("backward_device_ms")
    return ms / s["batches"] if ms else None
