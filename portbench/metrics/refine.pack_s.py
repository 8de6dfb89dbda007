"""refine.pack_s: ``refine_mappings``' ``stats["pack_s"]`` (pair extraction,
``pack_problems`` and the copy to the card), the mean of the window's
jobs; nothing where the jobs do not refine."""


def read(run):
    walls = [j.stats["pack_s"] for j in run.jobs if "pack_s" in j.stats]
    return sum(walls) / len(walls) if walls else None
