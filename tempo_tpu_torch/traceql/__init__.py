"""TraceQL: the traces-first query language (reference `pkg/traceql/`).

Counterpart of `tempo_tpu/traceql/`: the parser and AST mirror the
reference grammar (`pkg/traceql/expr.y`, `lexer.go`), evaluation is mask
algebra over struct-of-arrays span columns, and the metrics engine
scatters into [series x steps (x buckets)] torch grids on the device.
The in-memory views of live traces (`memview`) and the metrics summary
(`metrics_summary`) come with ROADMAP section 1, item 6b.
"""

from tempo_tpu_torch.traceql.ast import *  # noqa: F401,F403
from tempo_tpu_torch.traceql.parser import parse, ParseError  # noqa: F401
from tempo_tpu_torch.traceql.conditions import extract_conditions  # noqa: F401

_LATER = {"memview", "metrics_summary"}


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"tempo_tpu_torch.traceql.{name} comes with ROADMAP section 1, "
            f"item 6b")
    raise AttributeError(name)
