"""map.tier2_s: the span ``map.tier2``, the v2 mapper's second device pass
over the reads it deferred (its batches' spans inside it), the mean of the
window's v2 jobs, 0 for a job with no second pass; nothing where the jobs
mapped through the v1 join."""

from portbench.spans import job_mean


def read(run):
    jobs = [j for j in run.jobs if j.map_stats.get("v2") and "map.dispatch_n" in j.stats]
    return job_mean(run, ("map.tier2",), jobs=jobs)
