"""A throwaway benchmark root for the CPU tests: tiny configurations and
traffic written as new files beside a BENCHMARK.json of their own, found by
name as the real ones are."""

from __future__ import annotations

import json
import os
import shutil

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

CELLS = {
    "tiny-sa-edit": ("tiny-stable-audio", "tiny-edit"),
    "tiny-aldm-edit": ("tiny-audioldm", "tiny-edit-mel"),
    "tiny-sa-pcx": ("tiny-stable-audio", "tiny-pcx"),
}


def make_root(root: str, limits: dict = None) -> str:
    """Write the tiny benchmark under ``root``; ``limits`` maps a cell to
    its limits file's contents."""
    for kind in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(root, "portbench", kind), exist_ok=True)
    configs = []
    for name in ("tiny-stable-audio", "tiny-audioldm"):
        rel = f"portbench/configs/{name}.json"
        shutil.copy(os.path.join(DATA, name + ".json"), os.path.join(root, rel))
        configs.append({"name": name, "source": "test", "file": rel, "reduced": [], "why": "test"})
    for name in ("tiny-edit", "tiny-edit-mel", "tiny-pcx"):
        shutil.copy(os.path.join(DATA, name + ".json"),
                    os.path.join(root, "portbench", "traffic", name + ".json"))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "..", "BENCHMARK.json")) as f:
        real = json.load(f)
    cells = [{"name": c, "config": cfg, "traffic": tr, "chips": 1, "why": "test"}
             for c, (cfg, tr) in CELLS.items()]
    edits = [c for c, (_, tr) in CELLS.items() if tr.startswith("tiny-edit")]
    pcx = [c for c, (_, tr) in CELLS.items() if tr == "tiny-pcx"]

    def cells_of(entry):
        if "workloads" not in entry:
            return entry
        return dict(entry, workloads=edits if entry["name"].endswith(".edit") or
                    entry["name"].startswith("edit_") else pcx)

    bench = dict(real, configs=configs, workloads=cells,
                 end_to_end=[cells_of(e) for e in real["end_to_end"]],
                 per_layer=[cells_of(e) for e in real["per_layer"]])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for cell, lim in (limits or {}).items():
        with open(os.path.join(root, "portbench", "limits", cell + ".json"), "w") as f:
            json.dump(lim, f)
    return root
