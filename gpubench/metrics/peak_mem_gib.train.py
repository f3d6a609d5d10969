"""peak_mem_gib.train (GiB): the most memory allocated on the device during
the window (torch.cuda.max_memory_allocated after a reset at its start)."""


def read(record, trace):
    peak = record.get("window_peak_bytes", 0)
    return peak / 2 ** 30 if peak > 0 else None
