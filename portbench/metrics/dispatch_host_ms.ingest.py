"""Mean host time of one span-metrics scheduler dispatch (build and
launch of a merged batch) over the window, from the deltas of
`tempo_sched_dispatch_duration_seconds` sum over count, in milliseconds."""

from portbench.core.scrape import delta

KERNEL = "spanmetrics_fused_update"
NAME = "tempo_sched_dispatch_duration_seconds"


def read(rec):
    before, after = rec.data["counters"]
    n = delta(before, after, NAME + "_count", kernel=KERNEL)
    if n <= 0:
        return None
    return delta(before, after, NAME + "_sum", kernel=KERNEL) / n * 1e3
