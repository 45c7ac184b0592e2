"""Device ms a batch of the two coarse matchings (the forward's
`coarse_match_1` and `coarse_match_2` ranges), over the traced stretch of
a matching cell."""


def read(s):
    ms = s["stage_ms"].get("coarse_match_1", 0.0) \
        + s["stage_ms"].get("coarse_match_2", 0.0)
    return ms / s["batches"] if ms else None
