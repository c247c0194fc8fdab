"""Time the PyTorch port's edit from two checkouts, in turns, on one card.

    python3 edit_timing.py --trees OLD NEW [--model audioldm|stable_audio]
                           [--dtype bfloat16|float32]

Runs the port CLI (``python -m audioeditingcode_tpu_torch.cli.run``) in
``--dtype`` (default bfloat16) from the trees in the order OLD, NEW, NEW,
OLD, each run its own process, on the synthetic 10 s clip and the edit of
``chip_smoke.py`` phases 3 and 4 (``chip_smoke.edit_argv``: AudioLDM-s 200
+ 100 steps, Stable Audio Open 100 + 50 steps; random seeded weights). Each
tree builds its own kernels into its own ``build/kernels`` before the first
timed run. Prints one JSON line: every run's edit seconds (the CLI's
synchronised host clock around the two editing loops, from its
``run_args.json``) and each tree's median. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from chip_smoke import EDITS, MODEL_ID, SA_MODEL_ID, edit_argv, nvidia_smi_line, write_clip

MODELS = {"audioldm": MODEL_ID, "stable_audio": SA_MODEL_ID}


def run_edit(tree: str, model_id: str, clip: str, out_dir: str, dtype: str) -> float:
    """One CLI edit from ``tree`` in ``dtype``; returns its edit seconds."""
    argv = [sys.executable, "-m", "audioeditingcode_tpu_torch.cli.run",
            *edit_argv(model_id, clip, out_dir), "--dtype", dtype]
    proc = subprocess.run(argv, cwd=tree, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"edit from {tree} failed:\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    saved = [line.split("[+] saved ", 1)[1] for line in proc.stdout.splitlines()
             if line.startswith("[+] saved ")]
    with open(os.path.join(os.path.dirname(saved[-1]), "run_args.json")) as f:
        return json.load(f)["edit_seconds"]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trees", nargs=2, required=True, metavar=("OLD", "NEW"))
    p.add_argument("--model", choices=sorted(MODELS), default="stable_audio")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("edit_timing: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    model_id = MODELS[args.model]
    old, new = (os.path.abspath(t) for t in args.trees)
    for tree in (old, new):  # each tree's kernels, built before any timed run
        subprocess.run([sys.executable, "-c", "from audioeditingcode_tpu_torch.ops import "
                        "build; build.build()"], cwd=tree, check=True, timeout=900)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.wav")
        write_clip(clip, **EDITS[model_id][3])
        for tree in (old, new, new, old):
            seconds = run_edit(tree, model_id, clip, os.path.join(tmp, f"run{len(runs)}"),
                               args.dtype)
            runs.append({"tree": args.trees[tree == new], "edit_s": seconds})
            print(f"[edit_timing] {runs[-1]}", flush=True)
    medians = {t: statistics.median(r["edit_s"] for r in runs if r["tree"] == t)
               for t in args.trees}
    print(json.dumps({"model": args.model, "dtype": args.dtype, "runs": runs,
                      "median_edit_s": medians, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
