"""Peak device memory allocated over the window, GiB
(torch.cuda.max_memory_allocated after reset_peak_memory_stats)."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
