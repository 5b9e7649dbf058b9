"""The serving mesh's config block and its process switch.

Counterpart of the part of `tempo_tpu/parallel/serving.py` that the App
calls (`MeshConfig`, `configure`, `active`; reference `:54-100,245-266`)
and of `parallel/mesh.validate_mesh_shape`, which `MeshConfig.check`
uses. With the mesh off (the default)
`configure` returns None, as the reference's does. Sharded serving
(registry and sketch state over a 'series' axis, the in-mesh combine)
comes with mesh serving (ROADMAP section 1, item 13): `configure` raises
naming that item when the mesh is on.
"""

from __future__ import annotations

import dataclasses

MESH_LATER = ("mesh serving (mesh.enabled) comes with ROADMAP section 1, "
              "item 13")


@dataclasses.dataclass
class MeshConfig:
    """Knobs for the serving mesh (`mesh:` in the app YAML)."""

    enabled: bool = False
    # devices to enlist; 0 = every visible device. Non-power-of-two
    # counts are clamped DOWN to the largest power of two so pow-2
    # coalescer buckets always split evenly across shards.
    devices: int = 0
    # series shards; 0 = auto (all enlisted devices — data axis 1, the
    # bit-stable no-collective layout). Must divide the device count;
    # devices // series_shards becomes the 'data' axis.
    series_shards: int = 0
    # frontend in-mesh combine: minimum pending sample count
    # (series x steps) before the cross-shard fold rides the device
    # reduce — small folds are microseconds on the host, and the device
    # path pays a matrix build + H2D + dispatch + gather
    combine_min_elements: int = 16384

    def check(self) -> list[str]:
        """Config warnings (chained into `app.config.Config.check()`).
        Pure shape math — never touches a device."""
        problems = []
        if self.devices < 0:
            problems.append("mesh.devices must be >= 0 (0 = all)")
        elif self.devices and self.devices & (self.devices - 1):
            problems.append(
                f"mesh.devices ({self.devices}) is not a power of two: "
                f"serve time clamps to {_pow2_floor(self.devices)} so "
                "pow-2 batch buckets split evenly across shards")
        if self.series_shards < 0:
            problems.append("mesh.series_shards must be >= 0 (0 = auto)")
        if self.devices and self.series_shards:
            problems += validate_mesh_shape(_pow2_floor(self.devices),
                                            self.series_shards)
        if self.combine_min_elements < 1:
            problems.append("mesh.combine_min_elements must be >= 1")
        return ["mesh: " + p for p in problems] if problems else []


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def validate_mesh_shape(n_devices: int, series_shards: int) -> list[str]:
    """Config-style problem list for a proposed mesh shape (empty = ok)
    (reference `parallel/mesh.py:35-50`)."""
    problems = []
    if series_shards < 1:
        problems.append(f"mesh series_shards must be >= 1 "
                        f"(got {series_shards})")
    elif series_shards > n_devices:
        problems.append(f"mesh series_shards ({series_shards}) exceeds the "
                        f"device count ({n_devices}): shards <= devices")
    elif n_devices % series_shards:
        problems.append(f"mesh series_shards ({series_shards}) must divide "
                        f"the device count ({n_devices})")
    return problems


def configure(cfg: MeshConfig | None) -> None:
    """The process serving mesh from the `mesh:` config block: None with
    the mesh off; the mesh on raises naming item 13."""
    if cfg is not None and cfg.enabled:
        raise NotImplementedError(MESH_LATER)
    return None


def active() -> None:
    """The process serving mesh: none until item 13."""
    return None


__all__ = ["MeshConfig", "MESH_LATER", "configure", "active",
           "validate_mesh_shape"]
