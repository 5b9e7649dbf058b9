"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's pieces are found by name (`core/spec.py`). With `--trace 0`
the result's metrics are the cell's end-to-end metrics; with `--trace 1`
its per-layer metrics, read from a device trace of part of the window
and from the program's counters. Both runs check the program's answers
against the plain reference and print each compared number beside its
limit, last on standard error and last in the result line. The run
needs a CUDA card, the port beside this folder, and neither JAX nor the
JAX package in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()     # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tempo_tpu")


def _environment() -> None:
    """Kernel and build caches at fixed places inside the checkout; no
    library may bring JAX in."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from portbench.core import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec = spec.system(cell.config["system"]).run(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda",
        t_start=T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the process holds {loaded}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(rec.end_to_end[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": _card_name(), "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": bool(rec.correct), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device}
    if args.trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}",
          file=sys.stderr)
    print(f"portbench: phases {rec.data.get('phases_s')}", file=sys.stderr)
    if rec.trace is not None:
        print(f"portbench: trace cost {rec.trace.cost_s}", file=sys.stderr)
    for line in rec.data.get("diag", []):
        print(f"portbench: {line}", file=sys.stderr)
    for k in rec.data.get("errors", []):
        print(f"portbench: push error {k}", file=sys.stderr)
    for k, (v, lim) in rec.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
