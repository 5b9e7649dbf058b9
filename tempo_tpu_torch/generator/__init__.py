"""Metrics generator: per-tenant instances, processors, remote write."""

from tempo_tpu_torch.generator.instance import GeneratorConfig, GeneratorInstance

__all__ = ["GeneratorConfig", "GeneratorInstance"]
