"""myers_full_roofline: the exact-Myers kernel's share of its bound, in %.

The bound of one job's call is ``portbench.roofline.myers_full_work`` on the
job's own problems (each PAF line's unitig range against its read range, as
refinement packs them) at the card's int32 rate; the time is the device time
of the kernels named ``myers_full`` in the traced window.  The share is the
bounds of the window's jobs summed over that time."""

from portbench.roofline import bound_s, card_int32_rate, myers_full_work


def read(run):
    if run.trace is None or not run.jobs or not run.sm_count:
        return None
    kernel_s = sum(s for n, s in run.trace.device_ops.items() if "myers_full" in n)
    rate = card_int32_rate(run.sm_count)
    if kernel_s <= 0 or rate is None:
        return None
    total = 0.0
    for job in run.jobs:
        cols = [line.split("\t") for line in job.lines]
        q = [int(c[3]) - int(c[2]) for c in cols]
        t = [int(c[8]) - int(c[7]) for c in cols]
        total += bound_s(*myers_full_work(q, t), rate)
    return 100.0 * total / kernel_s
