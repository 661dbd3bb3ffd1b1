"""``torch.cuda.max_memory_allocated()`` over set-up and window, read as
the window closes, before any part of the correctness check runs."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
