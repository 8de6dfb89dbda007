"""map.collect_s: the self time of the span ``map.collect``, each batch's
hits unpacked into ``Mapping`` rows and triaged for tier 2 or the host, its
child spans ``map.wait`` and ``map.repull`` taken out, summed over a job;
the mean of the window's jobs."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.collect",), minus=("map.wait", "map.repull"))
