"""Device ms a train step inside the forward's six stage ranges (the
kernels launched under them; the backward's run outside them)."""

STAGES = ("backbone", "coarse_transformer", "coarse_match_1", "gam",
          "coarse_match_2", "fine")


def read(s):
    ms = sum(s["stage_ms"].get(k, 0.0) for k in STAGES)
    return ms / s["batches"] if ms else None
