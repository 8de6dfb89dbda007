"""map.host_map_s: the wall of the host mapper's call on the reads the
device flagged (``DEVICE_MAP_STATS["host_map_s"]``), the mean of the
window's jobs; nothing where no job sent a read to the host."""


def read(run):
    walls = [j.map_stats["host_map_s"] for j in run.jobs if "host_map_s" in j.map_stats]
    if not walls or not any(j.map_stats.get("overflow_reads") for j in run.jobs):
        return None
    return sum(walls) / len(walls)
