"""refine.pairs_s: the span ``refine.pairs``, refinement's loop that slices
each mapping's unitig and read ranges (and reverse-complements the read's),
the mean of the window's jobs; nothing where the jobs do not refine."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("refine.pairs",))
