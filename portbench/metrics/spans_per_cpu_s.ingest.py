"""Spans acknowledged in the window over the process CPU seconds the
window took (every thread of the process, the program's own with it)."""


def read(rec):
    cpu = rec.data.get("cpu_s", 0.0)
    return rec.data["spans"] / cpu if cpu > 0 else None
