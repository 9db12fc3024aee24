"""Host milliseconds a step of the batch's host loop (models/batch), the
median over the traced run's counted chunks: the host clock at each call
of the per-step function, no sync."""

import statistics


def read(t):
    return statistics.median(t.host_step_ms) if t.host_step_ms else None
