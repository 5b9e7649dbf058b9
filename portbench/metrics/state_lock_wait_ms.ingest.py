"""Milliseconds threads waited on the tenants' registry state locks, per
push acknowledged in the window: the delta of the program's
`tempo_registry_state_lock_wait_seconds_total` (process runtime
registry; every thread's waits, ingest's and the scheduler's dispatch's
alike) over the window's pushes. None where the program has no such
counter."""

from portbench.core.scrape import delta

NAME = "tempo_registry_state_lock_wait_seconds_total"


def read(rec):
    before, after = rec.data["counters"]
    pushes = len(rec.data["push_s"])
    if not pushes or not any(name == NAME for name, _ in after):
        return None
    return delta(before, after, NAME) / pushes * 1e3
