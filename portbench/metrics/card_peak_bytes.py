"""card_peak_bytes: ``torch.cuda.max_memory_allocated()`` over the window,
its peak statistics reset as the window starts."""


def read(run):
    return run.peak_bytes or None
