"""refine.pad_s: the span ``refine.pad``, ``pack_problems`` padding every
pair into the (P, length) arrays of one batch, the mean of the window's
jobs; nothing where the jobs do not refine."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("refine.pad",))
