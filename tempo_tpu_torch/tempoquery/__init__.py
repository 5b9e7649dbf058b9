from tempo_tpu_torch.tempoquery.plugin import build_tempo_query_server

__all__ = ["build_tempo_query_server"]
