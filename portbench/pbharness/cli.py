"""``run.py``'s work: one run of one cell, its result as the last line of
standard output and the numbers compared, each beside its limit, as the
last lines of standard error."""

from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import sys
from typing import List, Optional

import torch

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "audioeditingcode_tpu")
KIND_PACKAGE = "pbharness.kinds"


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the harness's own tests and calibration, not the driver
    p.add_argument("--root", default=spec.ROOT, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--control", default=None, choices=("tf32", "fp8"), help=argparse.SUPPRESS)
    return p.parse_args(argv)


def loaded_forbidden() -> List[str]:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_once(args: argparse.Namespace, t0: float) -> dict:
    """The run's result object (without printing it)."""
    from audioeditingcode_tpu_torch.utils.device import resolve_device

    cell = spec.load_cell(args.workload, args.root)
    # the port's entry points select the card as its CLIs do (TF32 off for
    # the whole process)
    device = resolve_device(args.device)
    chips = int(cell.workload["chips"])
    kind = importlib.import_module(f"{KIND_PACKAGE}.{cell.traffic['kind']}")
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), device, t0,
                   control=args.control)
    metrics = {}
    if not args.trace:
        for e in cell.end_to_end:
            v = out.setup_s if e["name"] == "setup_s" else out.e2e.get(e["name"])
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        for e in cell.per_layer:
            v = spec.metric_reader(args.root, e["name"])(out.context)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    checks = {n: {"value": out.checks.get(n), "limit": cell.limits.get(n)} for n in kind.CHECKS}
    correct = (out.attempted > 0 and out.failed == 0
               and all(_finite(c["value"]) and _finite(c["limit"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
               "memory_peak_bytes": int(out.memory_peak_bytes), "power": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    t = out.context.trace if out.context is not None else None
    if args.trace and t is not None:
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    if out.notes:
        result["notes"] = out.notes
    result["checks"] = checks
    return result


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    if args.device == "cuda":
        cell = spec.load_cell(args.workload, args.root)
        need = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: {args.workload} needs {need} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    result = run_once(args, t0)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad} in the process that reports: refused", file=sys.stderr)
        return 4
    if "power" in result["device"]:
        print(f"card: {result['device']['power']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
