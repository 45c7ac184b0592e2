"""Device ms a batch of the forward's `fine` range (the kernels
launched under it, children included), over the traced stretch of a
matching cell."""


def read(s):
    ms = s["stage_ms"].get("fine")
    return ms / s["batches"] if ms else None
