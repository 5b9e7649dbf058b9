"""Process-wide fault-injection registry: named fault points, scripted
from config/env with deterministic seeds.

Counterpart of `tempo_tpu/utils/faults.py`, copied whole. Of its points
the port wires `sched.dispatch` (sched/scheduler.py batch dispatch); the
others come with the slices that port their modules.

Chaos engineering needs repeatable faults in PRODUCTION code paths, not
test doubles: the `bench.py chaos` fault-matrix arm and the durability
tests arm these points to prove the WAL / retry / handoff machinery
actually survives the failures it claims to. This generalizes the
ad-hoc helpers in `tests/conftest.py` (forced-pressure scheduler,
scripted remote-write endpoint): those fake a SPECIFIC dependency; a
fault point fails the real one, in place, under a seeded coin.

Contract:

- **Zero cost disarmed.** Call sites guard with the module-level flag::

      from tempo_tpu_torch.utils import faults
      ...
      if faults.ARMED:
          faults.fire("backend.write")

  `ARMED` is False unless at least one point is configured, so the hot
  push path pays exactly one module-attribute check and no call.
- **Deterministic.** Every point draws from its own `random.Random`
  seeded from (global seed, point name): the same config replays the
  same fault schedule, so a chaos failure reproduces.
- **Safe by default.** `Config.check()` refuses armed points unless
  `faults.allow: true`; the `TEMPO_FAULTS` env spec (JSON, for child
  processes a harness spawns) is honored only under the same gate.

Known points (each named for the op it fails, wired in that module):
`backend.read` / `backend.write` (object-store ops, backend/cloud.py
wrapper), `ring.kv.cas` (ring/kv.py CAS), `rpc.push` (rpc.py push
clients), `sched.dispatch` (sched/scheduler.py batch dispatch),
`fleet.checkpoint.write` (fleet/checkpoint.py blob write), `wal.fsync`
(generator/wal.py segment fsync).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time

_LOG = logging.getLogger("tempo_tpu_torch.faults")

KNOWN_POINTS = (
    "backend.read", "backend.write", "ring.kv.cas", "rpc.push",
    "sched.dispatch", "fleet.checkpoint.write", "wal.fsync",
)

# exception classes a spec may name — a registry, not eval()
_ERRORS = {
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


class InjectedFault(OSError):
    """Default exception for a firing point (an OSError so transport /
    storage retry paths treat it like the real failure class)."""


@dataclasses.dataclass
class FaultSpec:
    """One point's script: fire with `probability` (after skipping the
    first `after` evaluations), at most `count` times (0 = unlimited),
    adding `latency_s` sleep and raising `error` (named class, or the
    default InjectedFault; "none" = latency only)."""

    point: str
    probability: float = 0.0
    count: int = 0
    after: int = 0
    latency_s: float = 0.0
    error: str = ""

    def check(self) -> list[str]:
        problems = []
        if self.point not in KNOWN_POINTS:
            problems.append(f"unknown fault point {self.point!r} "
                            f"(known: {', '.join(KNOWN_POINTS)})")
        if not (0.0 <= self.probability <= 1.0):
            problems.append(f"fault {self.point}: probability "
                            f"{self.probability} outside [0, 1]")
        if self.count < 0 or self.after < 0 or self.latency_s < 0:
            problems.append(f"fault {self.point}: count/after/latency_s "
                            "must be >= 0")
        if self.error and self.error != "none" \
                and self.error not in _ERRORS:
            problems.append(f"fault {self.point}: unknown error class "
                            f"{self.error!r} (known: "
                            f"{', '.join(sorted(_ERRORS))} | none)")
        return problems


@dataclasses.dataclass
class FaultsConfig:
    """The `faults:` config block. `points` maps point name → spec dict
    (probability / count / after / latency_s / error)."""

    allow: bool = False
    seed: int = 0
    points: dict = dataclasses.field(default_factory=dict)

    def specs(self) -> list[FaultSpec]:
        return [FaultSpec(point=name, **(spec or {}))
                for name, spec in self.points.items()]

    def check(self) -> list[str]:
        problems = []
        try:
            specs = self.specs()
        except TypeError as e:
            return [f"faults: malformed point spec: {e}"]
        armed = [s for s in specs if s.probability > 0]
        if armed and not self.allow:
            problems.append(
                "faults.points arms fault injection but faults.allow is "
                "false: set `faults: {allow: true}` to confirm this "
                "process should fail on purpose")
        for s in specs:
            problems.extend(s.check())
        return ["faults: " + p for p in problems] if problems else []


class _Point:
    __slots__ = ("spec", "rng", "fired", "evals")

    def __init__(self, spec: FaultSpec, seed: int) -> None:
        self.spec = spec
        # per-point stream: adding/removing one point never perturbs
        # another's schedule
        self.rng = random.Random(f"{seed}:{spec.point}")
        self.fired = 0
        self.evals = 0


# -- process-wide state -------------------------------------------------------

ARMED = False                       # THE hot-path gate (module attribute)
_POINTS: dict[str, _Point] = {}
_LOCK = threading.Lock()
# injected-fault counters per point, read by tempo_faults_injected_total
STATS: dict[str, int] = {}


def configure(cfg: FaultsConfig | None) -> None:
    """Install the config's points (App build). Honors the TEMPO_FAULTS
    env JSON spec on top — only when the config allows faults, so a
    stray env var can never arm a production process."""
    global ARMED
    cfg = cfg or FaultsConfig()
    with _LOCK:
        _POINTS.clear()
        STATS.clear()
        if cfg.allow:
            for spec in cfg.specs():
                _POINTS[spec.point] = _Point(spec, cfg.seed)
            env = os.environ.get("TEMPO_FAULTS", "")
            if env:
                try:
                    doc = json.loads(env)
                    for name, d in doc.items():
                        spec = FaultSpec(point=name, **(d or {}))
                        _POINTS[name] = _Point(spec, cfg.seed)
                except (ValueError, TypeError) as e:
                    _LOG.error("TEMPO_FAULTS unparseable (%s): ignored", e)
        for name in _POINTS:
            STATS[name] = 0
        armed = {n: dataclasses.asdict(p.spec)
                 for n, p in _POINTS.items() if p.spec.probability > 0}
        ARMED = bool(armed)
        if armed:
            _LOG.warning("fault injection ARMED: %s", armed)


def reset() -> None:
    """Disarm every point (test isolation)."""
    global ARMED
    with _LOCK:
        _POINTS.clear()
        STATS.clear()
        ARMED = False


class use:
    """Context manager arming a spec list for a with-block (tests and
    the chaos bench's parent-process arms)."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0) -> None:
        self.specs = specs
        self.seed = seed

    def __enter__(self) -> "use":
        global ARMED
        with _LOCK:
            self._saved = dict(_POINTS)
            self._saved_stats = dict(STATS)
            self._saved_armed = ARMED
            for spec in self.specs:
                _POINTS[spec.point] = _Point(spec, self.seed)
                STATS.setdefault(spec.point, 0)
            ARMED = any(p.spec.probability > 0 for p in _POINTS.values())
        return self

    def __exit__(self, *exc) -> None:
        global ARMED
        with _LOCK:
            _POINTS.clear()
            _POINTS.update(self._saved)
            STATS.clear()
            STATS.update(self._saved_stats)
            ARMED = self._saved_armed


def fire(point: str) -> None:
    """Evaluate one fault point. Call ONLY behind an `if faults.ARMED`
    guard. May sleep (latency faults) and may raise (error faults)."""
    p = _POINTS.get(point)
    if p is None:
        return
    spec = p.spec
    with _LOCK:
        p.evals += 1
        if p.evals <= spec.after:
            return
        if spec.count and p.fired >= spec.count:
            return
        if spec.probability < 1.0 and p.rng.random() >= spec.probability:
            return
        p.fired += 1
        STATS[point] = STATS.get(point, 0) + 1
    if spec.latency_s:
        time.sleep(spec.latency_s)
    if spec.error != "none":
        cls = _ERRORS.get(spec.error, InjectedFault)
        raise cls(f"injected fault at {point} "
                  f"(#{p.fired}, p={spec.probability})")


def stats() -> dict[str, int]:
    with _LOCK:
        return dict(STATS)


# -- obs: registered at import (App._build imports this module) so the
# dashboards/alerts drift gate sees the family on every deployment ----------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402

RUNTIME.counter_func(
    "tempo_faults_injected_total",
    lambda: [((point,), float(n)) for point, n in stats().items()],
    help="Faults injected per armed fault point (utils/faults.py; "
         "nonzero outside a chaos run means TEMPO_FAULTS leaked into "
         "a real deployment — runbook 'Crash recovery and fault "
         "injection')",
    labels=("point",))
