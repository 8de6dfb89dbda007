"""map.host_read_share: the share of reads that the device mapper sent to
the host mapper (``overflow_reads / total_reads`` of
``DEVICE_MAP_STATS``), over the window's jobs, in %."""


def read(run):
    total = sum(j.map_stats.get("total_reads", 0) for j in run.jobs)
    host = sum(j.map_stats.get("overflow_reads", 0) for j in run.jobs)
    return 100.0 * host / total if total else None
