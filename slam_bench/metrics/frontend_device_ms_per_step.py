"""Device milliseconds a step of the batch (frontend_step under torch.func.vmap):
the device time of the kernels launched inside the traced layer chunk's
`frontend_step` ranges, over the number of ranges; nothing where none ran."""


def read(t):
    n, secs = t.layers.get("frontend_step", (0, 0.0))
    return 1e3 * secs / n if n else None
