"""TraceQL: the traces-first query language (reference `pkg/traceql/`).

Counterpart of `tempo_tpu/traceql/`: the parser and AST mirror the
reference grammar (`pkg/traceql/expr.y`, `lexer.go`), evaluation is mask
algebra over struct-of-arrays span columns, and the metrics engine
scatters into [series x steps (x buckets)] torch grids on the device.
`memview` builds views of in-memory traces (the ingesters' recent data)
and `metrics_summary` is the span-metrics summary engine.
"""

from tempo_tpu_torch.traceql.ast import *  # noqa: F401,F403
from tempo_tpu_torch.traceql.parser import parse, ParseError  # noqa: F401
from tempo_tpu_torch.traceql.conditions import extract_conditions  # noqa: F401
