"""device_idle: the share of the traced window in which no kernel and no
copy ran on the card (``torch.profiler``), in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
