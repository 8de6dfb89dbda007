"""map.tables_s: the device tables a job's mapping builds before its first
batch, the spans ``map.v2_tables`` (the v2 tables built, or refused for an
index past their packing bounds) and ``map.v1_tables`` (the v1 join's tables
and the index's arrays copied to the card), the mean of the window's jobs."""

from portbench.spans import job_mean


def read(run):
    return job_mean(run, ("map.v2_tables", "map.v1_tables"))
