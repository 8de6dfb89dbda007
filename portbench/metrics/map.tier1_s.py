"""map.tier1_s: the span ``map.tier1``, the v2 mapper's first device pass
over every read (its batches' spans inside it), the mean of the window's v2
jobs; nothing where the jobs mapped through the v1 join or the program has
no such span."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.tier1",))
