"""Span data model: interner, SpanBatch tensors, OTLP wire codec."""

from tempo_tpu_torch.model.interner import INVALID_ID, StringInterner
from tempo_tpu_torch.model.otlp import (encode_spans_otlp, otlp_proto_to_batch,
                                        spans_from_otlp_proto)
from tempo_tpu_torch.model.span_batch import SpanBatch, SpanBatchBuilder

__all__ = ["INVALID_ID", "StringInterner", "SpanBatch", "SpanBatchBuilder",
           "encode_spans_otlp", "otlp_proto_to_batch", "spans_from_otlp_proto"]
