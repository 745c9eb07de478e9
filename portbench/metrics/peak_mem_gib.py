"""``torch.cuda.max_memory_allocated`` over set-up and window, of the
fullest device, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30
