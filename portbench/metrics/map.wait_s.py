"""map.wait_s: the span ``map.wait``, the host blocked on each batch's copy
back from the card, summed over a job; the mean of the window's jobs."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.wait",))
