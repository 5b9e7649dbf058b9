"""tempo_tpu_torch.matview — the materialized query grids (not yet ported).

Counterpart of `tempo_tpu/matview/`. The grids themselves come with
ROADMAP section 1, item 8. Until then no process materializer exists:
`materializer()` returns None, the reference's value when nothing was
configured (`tempo_tpu/matview/materializer.py:794,811`), so the query
frontend's materialized tier stays out of the way; `configure` and the
tier's classes raise naming item 8.
"""

from __future__ import annotations

_LATER = ("the materialized query grids (tempo_tpu_torch.matview.{}) come "
          "with ROADMAP section 1, item 8")


def configure(cfg=None, overrides=None, now=None):
    """Install the process materializer: raises until item 8."""
    raise NotImplementedError(_LATER.format("configure"))


def materializer() -> None:
    """The process materializer: none is ever configured in the port."""
    return None


def reset() -> None:
    """Drop the process materializer (tests): there is none to drop."""


def __getattr__(name: str):
    if name in ("Materializer", "MatViewConfig", "Subscription",
                "query_supported"):
        raise NotImplementedError(_LATER.format(name))
    raise AttributeError(name)


__all__ = ["configure", "materializer", "reset"]
