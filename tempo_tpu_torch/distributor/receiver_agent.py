"""Jaeger agent UDP receiver: thrift-compact `Agent.emitBatch` datagrams.

The deprecated-but-deployed jaeger client path (ref
`modules/distributor/receiver/shim.go:165-171`, jaeger `thrift_compact`
protocol on port 6831). Datagrams decode via
`model.jaeger.spans_from_jaeger_agent` and push through the SAME
distributor entry as every other receiver. UDP has no reply channel:
malformed datagrams and push failures are counted, never raised.

Counterpart of `tempo_tpu/distributor/receiver_agent.py`, host code copied with
its imports moved to the port.
"""

from __future__ import annotations

import dataclasses
import socket
import threading

from tempo_tpu_torch.model.jaeger import spans_from_jaeger_agent


@dataclasses.dataclass
class JaegerAgentConfig:
    # SECURITY: this receiver is an UNAUTHENTICATED single-tenant UDP
    # ingest — it binds loopback by default. Exposing it on every
    # interface requires the explicit opt-in below; set it only on
    # networks where the agent port is meant to be reachable (the
    # reference ships the same unauthenticated jaeger agent surface).
    host: str = "127.0.0.1"
    port: int = 6831             # jaeger thrift-compact agent port
    allow_wildcard_bind: bool = False   # opt-in for 0.0.0.0 / :: binds
    tenant: str = "single-tenant"
    max_datagram: int = 65_000


class JaegerAgentReceiver:
    def __init__(self, distributor, cfg: JaegerAgentConfig | None = None):
        self.distributor = distributor
        self.cfg = cfg or JaegerAgentConfig()
        self.batches_received = 0
        self.spans_received = 0
        self.errors = 0
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    @property
    def port(self) -> int:
        assert self._sock is not None
        return self._sock.getsockname()[1]

    def start(self) -> None:
        host = self.cfg.host
        if host in ("", "0.0.0.0", "::") and not self.cfg.allow_wildcard_bind:
            raise ValueError(
                "jaeger agent wildcard bind requires "
                "allow_wildcard_bind=True (unauthenticated UDP ingest on "
                "all interfaces); default to 127.0.0.1 instead")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, self.cfg.port))
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _addr = self._sock.recvfrom(self.cfg.max_datagram)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                spans = spans_from_jaeger_agent(data)
                if spans:
                    self.distributor.push_spans(
                        self.cfg.tenant, spans, size_bytes=len(data))
                self.batches_received += 1
                self.spans_received += len(spans)
            except Exception:
                self.errors += 1     # UDP: count and drop, nobody to answer

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self._sock is not None:
            self._sock.close()
