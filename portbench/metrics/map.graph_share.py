"""map.graph_share: the share of the v2 mapper's batches that replayed a
captured CUDA graph (``graph_batches / (graph_batches + eager_batches)`` of
``DEVICE_MAP_STATS``), over the window's v2 jobs, in %; nothing where the
jobs mapped through the v1 join or the program has no such counters."""


def read(run):
    jobs = [j for j in run.jobs if j.map_stats.get("v2")]
    graph = sum(j.map_stats.get("graph_batches", 0) for j in jobs)
    eager = sum(j.map_stats.get("eager_batches", 0) for j in jobs)
    return 100.0 * graph / (graph + eager) if graph + eager else None
