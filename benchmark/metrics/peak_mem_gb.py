"""torch.cuda.max_memory_allocated over set-up and window, in GB."""


def read(run):
    return run.peak_bytes / 1e9 if run.card else None
