"""Host syncs a chunk of process_chunk: the sync-debug warnings of the
traced run's counted chunks, their mean."""


def read(t):
    c = t.syncs_per_chunk
    return sum(c) / len(c) if c else None
