"""peak_mem_gb: the card's peak of allocated memory over set-up and
window (``torch.cuda.max_memory_allocated``), in 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
