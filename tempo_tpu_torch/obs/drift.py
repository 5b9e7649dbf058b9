"""Alert/dashboard ↔ registry drift gate.

Counterpart of `tempo_tpu/obs/drift.py`: the repo's `operations/` files
are read as data, and the registries checked are the port's (an App's
and `obs.runtime.RUNTIME`). The bail-cause gate reads the port's own
`tempo_tpu_torch/block/device_scan.py`.

Extracts every `tempo_*` metric name referenced by
`operations/alerts.yaml` and `operations/dashboards/*.json` and checks
each against the set of names actually registered in the obs registries
— the guarantee the tempo-mixin gets from generating everything out of
one jsonnet tree. A dashboard panel or alert expression can no longer
reference a metric this process never emits.

Used three ways: `operations/check_metrics_drift.py` (CLI, wired into
the `gen_dashboards.py --check` flow), the CI test
(tests/test_obs.py::test_ops_metric_names_registered), and ad-hoc from a
REPL against a live App.
"""

from __future__ import annotations

import json
import os
import re

METRIC_NAME_RE = re.compile(r"\btempo_[a-z0-9_]+")

# tokens the regex catches that are prose, not metric names (the python
# package name shows up in dashboard descriptions)
_NOT_METRICS = frozenset({"tempo_tpu", "tempo_tpu_torch"})


def referenced_metric_names(ops_dir: str) -> dict[str, set[str]]:
    """{metric_name -> {relative file paths referencing it}} over
    alerts.yaml + dashboards/*.json."""
    out: dict[str, set[str]] = {}

    def scan(path: str) -> None:
        rel = os.path.relpath(path, ops_dir)
        with open(path) as f:
            text = f.read()
        for name in METRIC_NAME_RE.findall(text):
            if name not in _NOT_METRICS:
                out.setdefault(name, set()).add(rel)

    alerts = os.path.join(ops_dir, "alerts.yaml")
    if os.path.exists(alerts):
        scan(alerts)
    dash_dir = os.path.join(ops_dir, "dashboards")
    if os.path.isdir(dash_dir):
        for fname in sorted(os.listdir(dash_dir)):
            if fname.endswith(".json"):
                # parse: a dashboard that stops being JSON should fail
                # here, not silently degrade to a text grep
                with open(os.path.join(dash_dir, fname)) as f:
                    json.load(f)
                scan(os.path.join(dash_dir, fname))
    return out


def registered_metric_names(registries) -> set[str]:
    out: set[str] = set()
    for reg in registries:
        out |= reg.metric_names()
    return out


def check_drift(ops_dir: str, registries) -> list[str]:
    """Return human-readable drift findings (empty = clean): every
    referenced metric name that no registry registers."""
    known = registered_metric_names(registries)
    problems: list[str] = []
    for name, files in sorted(referenced_metric_names(ops_dir).items()):
        if name in known:
            continue
        problems.append(
            f"{name} (referenced by {', '.join(sorted(files))}) is not "
            f"registered in the obs registry")
    return problems


_BAIL_RE = re.compile(r'_bail\("([a-z_]+)"\)')
_RUNBOOK_CAUSE_RE = re.compile(r"^\| `([a-z_]+)` \|", re.MULTILINE)


def check_bail_causes(ops_dir: str) -> list[str]:
    """Static source↔runbook gate: every `_bail("<cause>")` string in
    the port's `block/device_scan.py` must have a row in the runbook's
    fallback-cause table ("Reading the read plane"). A new refusal path
    cannot ship without an operator-facing explanation — the same
    one-source-of-truth guarantee the metric-name check gives
    dashboards."""
    repo = os.path.dirname(ops_dir)
    scan_path = os.path.join(repo, "tempo_tpu_torch", "block",
                             "device_scan.py")
    runbook_path = os.path.join(ops_dir, "runbook.md")
    problems: list[str] = []
    if not os.path.exists(scan_path) or not os.path.exists(runbook_path):
        return [f"bail-cause gate: missing {scan_path} or {runbook_path}"]
    with open(scan_path) as f:
        causes = set(_BAIL_RE.findall(f.read()))
    with open(runbook_path) as f:
        documented = set(_RUNBOOK_CAUSE_RE.findall(f.read()))
    for cause in sorted(causes - documented):
        problems.append(
            f'_bail("{cause}") in block/device_scan.py has no row in the '
            f"runbook fallback-cause table (operations/runbook.md, "
            f'"Reading the read plane")')
    return problems


def default_registries(device=None):
    """Boot a `target=all` in-memory App on `device` (`cuda` unless
    `"cpu"` is asked for) and return its registries — the canonical
    "what does a full process register" answer for the CLI gate. Caller
    must App.shutdown() the returned app."""
    import tempfile

    from tempo_tpu_torch.app import App
    from tempo_tpu_torch.app.config import Config
    from tempo_tpu_torch.obs.runtime import RUNTIME

    tmp = tempfile.mkdtemp(prefix="tempo-obs-drift-")
    cfg = Config(target="all")
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = os.path.join(tmp, "wal")
    cfg.generator.localblocks.data_dir = os.path.join(tmp, "lb")
    app = App(cfg, device=device)
    return [app.obs, RUNTIME], app


__all__ = ["referenced_metric_names", "registered_metric_names",
           "check_drift", "check_bail_causes", "default_registries",
           "METRIC_NAME_RE"]
