"""Device memory of the tenants' metric state at the window's close: the
`tempo_registry_state_bytes` gauge (registry families and sketch planes
of every tenant), in MiB."""

from portbench.core.scrape import total


def read(rec):
    _, after = rec.data["counters"]
    v = total(after, "tempo_registry_state_bytes")
    return v / 2**20 if v > 0 else None
