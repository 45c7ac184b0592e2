"""Model FLOPs utilization, in %: the model operations of the traced
steps (portbench/counts.py) over the elapsed time of as many steps run
untraced just before them (CUDA events at its two ends: the wall time of
the stretch, the host's pauses included, as the window's rate has it),
times the peak of the configuration's precision (bf16 989 TFLOP/s; float32
with TF32 off 67)."""


def read(s):
    if not s.get("flops") or not s.get("untraced_s"):
        return None
    return 100.0 * s["flops"] / (s["untraced_s"] * s["peak_flops"])
