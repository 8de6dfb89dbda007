"""map.read_pack_s: the span ``map.read_pack``, each batch's reads packed
on the host and their copy to the card started, summed over a job; the mean of
the window's jobs."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.read_pack",))
