"""Reads the program's counters as a scraper would: from the Prometheus
text exposition its registries render."""

from __future__ import annotations

import re

_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> dict:
    """{(sample name, ((label, value), ...)): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            continue
        labels = tuple(sorted(_LABEL.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def total(samples: dict, name: str, **match) -> float:
    """Sum of a sample name's values over the series whose labels hold
    `match`."""
    s = 0.0
    for (n, labels), v in samples.items():
        if n == name and all(dict(labels).get(k) == x
                             for k, x in match.items()):
            s += v
    return s


def delta(before: dict, after: dict, name: str, **match) -> float:
    return total(after, name, **match) - total(before, name, **match)
