"""The device memory allocated at its peak over the window, the resident
month included (``torch.cuda.max_memory_allocated`` after a reset at the
window's start), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
