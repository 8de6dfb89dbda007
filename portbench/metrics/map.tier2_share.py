"""map.tier2_share: the share of reads that took the v2 mapper's second
device pass (``tier2_reads / total_reads`` of ``DEVICE_MAP_STATS``), over
the window's jobs, in %; nothing where the jobs mapped through the v1
join, which has no second pass."""


def read(run):
    jobs = [j for j in run.jobs if j.map_stats.get("v2")]
    total = sum(j.map_stats.get("total_reads", 0) for j in jobs)
    tier2 = sum(j.map_stats.get("tier2_reads", 0) for j in jobs)
    return 100.0 * tier2 / total if total else None
