"""refine.copy_s: the span ``refine.copy``, the packed problems copied to
the card, the mean of the window's jobs; nothing where the jobs do not
refine."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("refine.copy",))
