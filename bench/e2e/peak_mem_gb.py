"""peak_mem_gb: `torch.cuda.max_memory_allocated()` over the measured
window (reset at its start), in GB (1e9)."""


def read(run):
    return run["peak_bytes"] / 1e9
