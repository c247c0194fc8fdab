"""Readings for the limits of ``correct``: the port's timed path judged on
many seeds, and the control (the reference one precision below the
configuration's, in the port's place) on some of them, in one process.

    python portbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds 1 2 3 ... [--control fp8|tf32 --control-seeds 1 2 3] [--trace-seeds 4 5]

Prints one line per seed: ``CAL`` and a JSON object with the seed, the
numbers compared (``checks``), the control's (``control``), and the run's
end-to-end metrics. The limits in ``limits/<cell>.json`` lie between the
largest port reading and the smallest control reading (``PERF.md``).
"""

import time

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from pbharness import cli  # noqa: E402


def main(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--trace-seeds", type=int, nargs="*", default=())
    a = p.parse_args(argv)
    for seed in a.seeds:
        args = cli.parse(["--workload", a.workload, "--seed", str(seed), "--seconds",
                          str(a.seconds), "--trace", str(int(seed in a.trace_seeds))]
                         + (["--control", a.control] if a.control and seed in a.control_seeds
                            else []))
        t0 = time.perf_counter()
        res = cli.run_once(args, t0)
        line = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"],
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "control": res.get("notes", [{}])[0].get("checks"),
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "run_s": time.perf_counter() - t0}
        print("CAL " + json.dumps(line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
