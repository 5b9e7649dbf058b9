"""The control: the plain reference put in the program's place, computed
in the precision below the one the configuration states.

    python3 portbench/control.py --workload <cell> --seeds <n> <n> <n>

The configuration states float32 state (span-metrics sums and counts);
the control computes in bfloat16 and is judged by the cell's own
comparison against the float64 reference, at the cell's own size: the
cell's templates pushed as often as a window of `run_seconds` at the
rate `--spans-per-s` would push them (the default is the cell's measured
median, PERF.md). It prints each compared number beside the cell's
limit; every control must fail at least one of them.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import spec  # noqa: E402
from portbench.reference import generator as refgen  # noqa: E402
from portbench.reference.generator import CONTROL_DTYPE, EDGES, Pushed  # noqa: E402
from portbench.reference.judge_generator import SG, SM, Tally  # noqa: E402


def _histogram(out: dict, name: str, keys, fam) -> None:
    cum = np.cumsum(fam.buckets, axis=1)
    les = [repr(float(e)) for e in EDGES] + ["+Inf"]
    rows = out.setdefault(name + "_bucket", {})
    for k, c in zip(keys, cum.tolist()):
        for le, v in zip(les, c):
            rows[k + (("le", le),)] = v
    out.setdefault(name + "_count", {}).update(zip(keys, fam.count.tolist()))
    out.setdefault(name + "_sum", {}).update(zip(keys, fam.sums.tolist()))


def as_program(ref: refgen.TenantReference, qs) -> tuple[dict, dict]:
    """A reference's series and quantiles in the shapes the harness reads
    from the program."""
    sm = ref.spanmetrics
    out: dict = {SM + "calls_total": dict(zip(sm.keys, sm.count.tolist())),
                 SM + "size_total": dict(zip(sm.keys, ref.sizes.tolist()))}
    _histogram(out, SM + "latency", sm.keys, sm)
    for side, fam in ref.edges.items():
        _histogram(out, f"{SG}{side}_seconds", fam.keys, fam)
    fam = ref.edges["client"]
    out[SG + "total"] = dict(zip(fam.keys, fam.count.tolist()))
    out[SG + "failed_total"] = dict(zip(fam.keys, fam.failed.tolist()))
    return out, ref.dd_quantiles(qs)


def generator_control(cell, seed: int, pushes_per_client: int,
                      dtype=CONTROL_DTYPE) -> dict:
    from portbench.systems.generator import _space, make_clients

    cfg, traffic = cell.config, cell.traffic
    space = _space(traffic)
    clients = make_clients(cfg, traffic, seed)
    qs = tuple(cfg["quantiles"])
    sm = cfg["spanmetrics"]
    tally = Tally()
    picked = np.sort(np.random.default_rng([seed, 13]).choice(
        int(cfg["tenants"]), int(cfg["check_tenants"]), replace=False))
    for t in picked.tolist():
        pushed = []
        for c in clients:
            if c.tenant != f"tenant-{t}":
                continue
            n = len(c.templates)
            for j, (cols, p) in enumerate(c.templates):
                times = pushes_per_client // n + (j < pushes_per_client % n)
                if times:
                    pushed.append(Pushed(cols, p.span_bytes, times))
        kw = dict(rel_err=sm["sketch_rel_err"], min_s=sm["sketch_min_s"],
                  max_s=sm["sketch_max_s"])
        ref = refgen.TenantReference(space, pushed, **kw)
        ctl = refgen.TenantReference(space, pushed, dtype=dtype, **kw)
        series, quant = as_program(ctl, qs)
        tally.add(series, quant, ref, qs, int(sm["sketch_max_series"]))
    return tally.numbers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--spans-per-s", type=float, default=143364.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    limits = cell.config["limits"]
    for seed in args.seeds:
        per_client = int(args.spans_per_s * seconds / cell.traffic[
            "spans_per_payload"] / (cell.config["tenants"] * cell.traffic[
                "clients_per_tenant"])) + int(
            cell.traffic["warmup_pushes_per_client"])
        got = generator_control(cell, seed, per_client)
        failed = [k for k, v in got.items() if v > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": got, "limits": limits,
                          "fails": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
