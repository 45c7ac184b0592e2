"""Share of their roofline that the GAM kernels reach, in %: the sum of
each launch's bound (portbench/counts.py, from the traced calls' own
inputs) over the sum of the device time of every launch of the kernels and
of their plan, count and sum launches. None where no launch was traced."""


def read(s):
    if not s.get("gam_kernel_ms"):
        return None
    return 100.0 * s["gam_bound_ms"] / s["gam_kernel_ms"]
