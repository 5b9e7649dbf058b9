"""Metrics generator: the multi-tenant service, per-tenant instances,
processors, remote write.

Counterpart of `tempo_tpu/generator/`, with the same exports.
"""

from tempo_tpu_torch.generator.remote_write import (
    RemoteWriteClient,
    encode_write_request,
    snappy_compress,
)
from tempo_tpu_torch.generator.instance import GeneratorConfig, GeneratorInstance
from tempo_tpu_torch.generator.generator import Generator
from tempo_tpu_torch.generator import pipeline as _pipeline  # noqa: F401  (registers obs families)

__all__ = ["Generator", "GeneratorConfig", "GeneratorInstance",
           "RemoteWriteClient", "encode_write_request", "snappy_compress"]
