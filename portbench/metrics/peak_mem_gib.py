"""peak_mem_gib: the most device memory allocated at once during the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
resident tables counted, in GiB."""


def read(w):
    return None if w.peak_bytes is None else w.peak_bytes / 2**30
