"""map.paf_s: the span ``map.paf``, ``map_all``'s PAF lines written from the
mappings, the mean of the window's jobs."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.paf",))
