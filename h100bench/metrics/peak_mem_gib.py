"""The device memory the window's requests held at their peak, in GiB:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(run, name):
    return run.peak_bytes / 2 ** 30
