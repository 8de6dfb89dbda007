"""refine.distance_s: ``refine_mappings``' ``stats["distance_s"]`` (the
distance kernel and the copy back), the mean of the window's jobs; nothing
where the jobs do not refine."""


def read(run):
    walls = [j.stats["distance_s"] for j in run.jobs if "distance_s" in j.stats]
    return sum(walls) / len(walls) if walls else None
