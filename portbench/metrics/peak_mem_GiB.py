"""``torch.cuda.max_memory_allocated`` over set-up and the window, GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
