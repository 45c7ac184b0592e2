"""Device ms a batch of the forward's `backbone` range (the kernels
launched under it, children included), over the traced stretch of a
matching cell."""


def read(s):
    ms = s["stage_ms"].get("backbone")
    return ms / s["batches"] if ms else None
