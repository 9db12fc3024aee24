"""Percent of the traced device chunk's wall time in which no device
activity ran: 1 - the union of the activity intervals over the window."""


def read(t):
    d = t.device
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"]) if d else None
