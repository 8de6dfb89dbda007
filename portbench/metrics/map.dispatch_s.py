"""map.dispatch_s: the span ``map.dispatch``, each batch's stage launches and
its copy back queued (the packing not in it), summed over a job; the mean of
the window's jobs."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.dispatch",))
