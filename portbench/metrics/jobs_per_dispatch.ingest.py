"""Span-metrics row jobs the device scheduler folded into each merged
dispatch over the window: the deltas of `tempo_sched_coalesced_jobs_total`
over `tempo_sched_batches_total` for K1's kernel label."""

from portbench.core.scrape import delta

KERNEL = "spanmetrics_fused_update"


def read(rec):
    before, after = rec.data["counters"]
    batches = delta(before, after, "tempo_sched_batches_total", kernel=KERNEL)
    if batches <= 0:
        return None
    return delta(before, after, "tempo_sched_coalesced_jobs_total",
                 kernel=KERNEL) / batches
