"""Service runtime: config, module wiring, HTTP API, targets.

Counterpart of `tempo_tpu/app/` (`cmd/tempo/app`): one YAML config drives
every module (`app/config.go:33-139`), a module manager wires the
dependency DAG for the selected `-target` (`modules.go:679-757`; `all` =
SingleBinary `modules.go:83,742`), and the server exposes the HTTP API
surface of `pkg/api/http.go:68-84`.
"""

from tempo_tpu_torch.app.config import Config, load_config
from tempo_tpu_torch.app.app import App

__all__ = ["App", "Config", "load_config"]
