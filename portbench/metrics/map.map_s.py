"""map.map_s: ``map_all``'s own ``stats["map_s"]`` (the mapping call, the
refinement not in it), the mean of the window's jobs."""


def read(run):
    walls = [j.stats["map_s"] for j in run.jobs if "map_s" in j.stats]
    return sum(walls) / len(walls) if walls else None
