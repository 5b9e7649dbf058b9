"""gRPC plane: OTLP/gRPC ingest + inter-service RPC + worker-pull dispatch.

The analog of the reference's entire gRPC surface (`pkg/tempopb/tempo.proto:9-44`
services Pusher / MetricsGenerator / Querier / StreamingQuerier carried by the
dskit server, plus the httpgrpc frontend↔querier tunnel
`modules/frontend/v1/frontend.go:204-293`).

Design: grpc generic method handlers over explicit wire payloads — the OTLP
receiver speaks the real `opentelemetry.proto.collector.trace.v1.TraceService`
protobuf (so stock OTel SDKs can export to it), while inter-service methods
carry this framework's own encodings (varint-framed span groups on the hot
push path, JSON on control paths). No generated stubs: the protobuf layer
that is 22k generated lines in the reference collapses into the wire codec
in `model/proto_wire.py`.

Counterpart of `tempo_tpu/grpcplane/__init__.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from tempo_tpu_torch.grpcplane.server import build_grpc_server
from tempo_tpu_torch.grpcplane.client import (
    GrpcGeneratorClient,
    GrpcIngesterClient,
    FrontendWorker,
)

__all__ = [
    "build_grpc_server",
    "GrpcIngesterClient",
    "GrpcGeneratorClient",
    "FrontendWorker",
]
