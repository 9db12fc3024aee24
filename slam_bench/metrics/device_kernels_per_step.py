"""Device activities (kernels, copies, fills) a step, from the traced
device chunk."""


def read(t):
    d = t.device
    return d["events"] / d["steps"] if d else None
