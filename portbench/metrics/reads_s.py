"""reads_s: the long reads of every job of the window over the jobs'
summed wall, each wall from the ``map_all`` call to its PAF lines."""


def read(run):
    wall = sum(j.wall_s for j in run.jobs)
    return sum(j.reads for j in run.jobs) / wall if wall > 0 else None
