"""What a run is made of, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its limits
(``limits/<cell>.json``) and the readers of its per-layer metrics
(``metrics/<name>.py``). Each kind of file is looked up in the directories
of ``search_dirs`` in turn, so a new cell, configuration, traffic mix or
metric is a new file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)  # the checkout


def search_dirs(root: str, kind: str) -> List[str]:
    """Where files of ``kind`` ('traffic', 'metrics', 'limits') live: the
    ``portbench`` folder of ``root``, then this one's."""
    dirs = [os.path.join(root, "portbench", kind), os.path.join(HERE, kind)]
    return list(dict.fromkeys(os.path.abspath(d) for d in dirs))


def _find(root: str, kind: str, name: str, ext: str) -> Optional[str]:
    for d in search_dirs(root, kind):
        path = os.path.join(d, name + ext)
        if os.path.isfile(path):
            return path
    return None


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    root: str
    bench: dict
    workload: dict  # the BENCHMARK.json entry
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: Dict[str, float]
    end_to_end: List[dict]  # the cell's end-to-end metric entries
    per_layer: List[dict]  # the cell's per-layer metric entries

    @property
    def name(self) -> str:
        return self.workload["name"]


def _for_cell(entries: List[dict], cell: str, reported: List[str]) -> List[dict]:
    """Entries that list ``cell`` under ``workloads``; an entry without the
    key belongs to every cell that reports the end-to-end metric it moves
    (per-layer) or to every cell (end to end)."""
    out = []
    for e in entries:
        if "workloads" in e:
            if cell in e["workloads"]:
                out.append(e)
        elif "moves" not in e or e["moves"] in reported:
            out.append(e)
    return out


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = _load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic_path = _find(root, "traffic", w["traffic"], ".json")
    if traffic_path is None:
        raise FileNotFoundError(f"no traffic file {w['traffic']}.json in "
                                f"{search_dirs(root, 'traffic')}")
    limits_path = _find(root, "limits", workload, ".json")
    limits = _load_json(limits_path) if limits_path else {}
    e2e = _for_cell(bench["end_to_end"], workload, [])
    reported = [e["name"] for e in e2e]
    return Cell(root=root, bench=bench, workload=w, config=config,
                traffic=_load_json(traffic_path), limits=limits, end_to_end=e2e,
                per_layer=_for_cell(bench["per_layer"], workload, reported))


def metric_reader(root: str, name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = _find(root, "metrics", name, ".py")
    if path is None:
        raise FileNotFoundError(f"no reader metrics/{name}.py in {search_dirs(root, 'metrics')}")
    spec = importlib.util.spec_from_file_location("pb_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
