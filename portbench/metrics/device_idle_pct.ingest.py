"""Share of the traced slice in which no device operation ran, percent."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
