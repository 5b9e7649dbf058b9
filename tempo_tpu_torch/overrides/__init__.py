"""Per-tenant limits: runtime-config overrides + user-configurable API.

Counterpart of `tempo_tpu/overrides/`, the analog of `modules/overrides`:
a `Limits` record per tenant (`modules/overrides/config.go:71-200`), a
reloading runtime-config source (`runtime_config_overrides.go`), and a
user-configurable subset persisted to the object-store backend
(`user_configurable_overrides.go`) that wins over runtime config for the
fields it carries.
"""

from tempo_tpu_torch.overrides.limits import Limits
from tempo_tpu_torch.overrides.overrides import Overrides, UserConfigurableOverrides

__all__ = ["Limits", "Overrides", "UserConfigurableOverrides"]
