"""Device milliseconds a mapping solve of the batch (models/mapping.mapping_step):
the device time of the kernels launched inside the traced layer chunk's
`mapping_step` ranges, over the number of ranges; nothing where none ran."""


def read(t):
    n, secs = t.layers.get("mapping_step", (0, 0.0))
    return 1e3 * secs / n if n else None
