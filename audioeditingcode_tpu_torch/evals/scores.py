"""Score orchestration over result-directory trees.

Counterpart of ``audioeditingcode_tpu/evals/scores.py`` (the reference's
``calc_scores`` / ``combine_scores``, evals/utils.py:119-411): walk the
CLIs' results layout, parse the config back out of the file names with the
same regexes, compute windowed CLAP consistency and LPAPS per generation,
checkpoint incrementally to the same JSON resume file, and build the same
tables. The card's machine has no pandas, so a table is a ``Table`` of
columns and rows; ``Table.to_csv`` writes what pandas' ``to_csv(index=False)``
writes for the same frame: the same header and row order, None and NaN as
an empty cell, floats as ``repr``, and a column of ints beside missing
values as floats, as pandas stores it.

Directory layout produced by the CLIs (cli/run.py, cli/sdedit.py):

  ours:   <root>/<model>/<input>/src_<src>/dec_<tar>__neg__<neg>/cfg_e_.._cfg_d_.._skip_.._<ts>.wav
  sdedit: <root>/<model>/<input>/pmt_<tar>__neg__<neg>/s<seed>_skip<skip>_cfg<cfg>.wav
"""

from __future__ import annotations

import csv
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.audio_io import read_wav
from .clap_consistency import CLAPTextConsistencyMetric
from .lpaps import LPAPS

_SKIP_RE = re.compile(r"_skip_(\d+)_")
_TARCFG_RE = re.compile(r"_cfg_d_(\d+)\.0_")
_SRCCFG_RE = re.compile(r"cfg_e_(\d+\.\d+)_")
_SDEDIT_RE = re.compile(r"s(?:\d+|None)_skip(\d+)_cfg(\d+(?:\.\d+)?)")


def _unmangle(s: str) -> str:
    return s.replace("_", " ")


def is_missing(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def _promote(values: Sequence[Any]) -> List[Any]:
    """A column as pandas stores it: ints beside floats or beside missing
    values become floats (NaN for the missing), a column of ints alone
    stays ints."""
    nums = [v for v in values if isinstance(v, (int, float)) and not isinstance(v, bool)]
    if any(isinstance(v, int) for v in nums) and (
            any(isinstance(v, float) for v in nums) or any(is_missing(v) for v in values)):
        return [float(v) if isinstance(v, int) else v for v in values]
    return list(values)


def _cell(x) -> str:
    if is_missing(x):
        return ""
    if isinstance(x, float):
        return repr(x)
    return str(x)


class Table:
    """Columns and rows: what the JAX package builds as a pandas frame."""

    def __init__(self, columns: Sequence[str], rows: Sequence[Sequence[Any]] = ()):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]
        for r in self.rows:
            if len(r) != len(self.columns):
                raise ValueError(f"row of {len(r)} cells for {len(self.columns)} columns")

    @classmethod
    def from_records(cls, records: Sequence[Dict[str, Any]]) -> "Table":
        """pandas.DataFrame(records): the keys in order of first appearance,
        each column promoted as pandas stores it."""
        columns: List[str] = []
        for rec in records:
            columns += [k for k in rec if k not in columns]
        cols = [_promote([rec.get(c) for rec in records]) for c in columns]
        return cls(columns, [list(r) for r in zip(*cols)] if records else [])

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[Any]:
        i = self.columns.index(name)
        return [r[i] for r in self.rows]

    def records(self) -> List[Dict[str, Any]]:
        return [dict(zip(self.columns, r)) for r in self.rows]

    def where(self, keep) -> "Table":
        """The rows whose record ``keep`` accepts."""
        return Table(self.columns, [r for r, rec in zip(self.rows, self.records()) if keep(rec)])

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            for r in self.rows:
                w.writerow([_cell(x) for x in r])


def read_csv(path: str) -> Table:
    """A CSV that ``Table.to_csv`` (or pandas) wrote, every cell a string
    (empty for a missing value)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return Table(rows[0], rows[1:])


@dataclass
class ScoreRecord:
    method: str
    audio_input: str
    source_prompt: str
    target_prompt: str
    skip: Optional[int] = None
    tarcfg: Optional[float] = None
    srccfg: Optional[float] = None
    clap: Optional[float] = None
    lpaps: Optional[float] = None
    path: str = ""

    def key(self) -> str:
        return "|".join(str(x) for x in (
            self.method, self.audio_input, self.source_prompt,
            self.target_prompt, self.skip, self.tarcfg, self.srccfg,
        ))


@dataclass
class ScoreState:
    records: Dict[str, ScoreRecord] = field(default_factory=dict)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({k: vars(r) for k, r in self.records.items()}, f)

    @classmethod
    def load(cls, path: str) -> "ScoreState":
        st = cls()
        if os.path.exists(path):
            with open(path) as f:
                st.records = {k: ScoreRecord(**v) for k, v in json.load(f).items()}
        return st


def _iter_ours(ours_root: str):
    """Yield (audio_input, src, tar, skip, tarcfg, srccfg, wav_path)."""
    for audio_input in sorted(os.listdir(ours_root)):
        inp_dir = os.path.join(ours_root, audio_input)
        if not os.path.isdir(inp_dir):
            continue
        for src_dir in sorted(os.listdir(inp_dir)):
            if not src_dir.startswith("src_"):
                continue
            src = _unmangle(src_dir[4:])
            for tar_dir in sorted(os.listdir(os.path.join(inp_dir, src_dir))):
                tar = _unmangle(tar_dir[4:].split("__neg__")[0])
                inner = os.path.join(inp_dir, src_dir, tar_dir)
                for f in sorted(os.listdir(inner)):
                    if not f.endswith(".wav") or f.startswith("orig"):
                        continue
                    skip_m = _SKIP_RE.search(f)
                    tarcfg_m = _TARCFG_RE.search(f)
                    srccfg_m = _SRCCFG_RE.search(f)
                    yield (
                        audio_input, src, tar,
                        int(skip_m.group(1)) if skip_m else None,
                        float(tarcfg_m.group(1)) if tarcfg_m else None,
                        float(srccfg_m.group(1)) if srccfg_m else None,
                        os.path.join(inner, f),
                    )


def _iter_musicgen(root: str):
    """MusicGen baseline lane (reference: evals/utils.py:211-216, 340-361):
    ``<root>/<audio_input>/prompt_<target prompt>.wav``, one flat generation
    per (input, target prompt), the prompt kept verbatim (``x[7:-4]``);
    only ``prompt_*.wav`` files belong to the lane."""
    for audio_input in sorted(os.listdir(root)):
        inp_dir = os.path.join(root, audio_input)
        if not os.path.isdir(inp_dir):
            continue
        for f in sorted(os.listdir(inp_dir)):
            if not f.endswith(".wav") or not f.startswith("prompt_"):
                continue
            yield (audio_input, "", f[7:-4], None, None, None, os.path.join(inp_dir, f))


def _iter_sdedit(root: str):
    for audio_input in sorted(os.listdir(root)):
        inp_dir = os.path.join(root, audio_input)
        if not os.path.isdir(inp_dir):
            continue
        for pmt_dir in sorted(os.listdir(inp_dir)):
            if not pmt_dir.startswith("pmt_"):
                continue
            tar = _unmangle(pmt_dir[4:].split("__neg__")[0])
            inner = os.path.join(inp_dir, pmt_dir)
            for f in sorted(os.listdir(inner)):
                if not f.endswith(".wav") or f.startswith("orig"):
                    continue
                m = _SDEDIT_RE.search(f)
                if not m:
                    continue
                yield (audio_input, "", tar, int(m.group(1)),
                       float(m.group(2)), None, os.path.join(inner, f))


def calc_scores(
    extractor,
    ours_dirs: Optional[List[str]] = None,
    sdedit_dirs: Optional[List[str]] = None,
    ddim_dirs: Optional[List[str]] = None,
    musicgen_dirs: Optional[List[str]] = None,
    musicgen_large_dirs: Optional[List[str]] = None,
    inputs_orig: Optional[str] = None,
    prev_pt: Optional[str] = None,
    win_length: Optional[float] = None,
    overlap: float = 0.1,
    method: str = "mean",
    verbose: bool = True,
) -> ScoreState:
    """Compute windowed CLAP + LPAPS for every generation found.

    Resumable: pass ``prev_pt`` to reuse previously computed records
    (reference: evals/utils.py:173-184). LPAPS is measured against the
    original input wav from ``inputs_orig`` (or the sibling orig.wav)."""
    clap = CLAPTextConsistencyMetric(extractor)
    lpaps = LPAPS(extractor)
    state = ScoreState.load(prev_pt) if prev_pt else ScoreState()

    orig_cache: Dict[str, tuple] = {}

    def orig_for(audio_input: str, gen_path: str):
        if audio_input in orig_cache:
            return orig_cache[audio_input]
        path = None
        if inputs_orig is not None:
            cand = os.path.join(inputs_orig, audio_input + ".wav")
            if os.path.exists(cand):
                path = cand
        if path is None:
            cand = os.path.join(os.path.dirname(gen_path), "orig.wav")
            if os.path.exists(cand):
                path = cand
        if path is None:
            orig_cache[audio_input] = None
            return None
        aud, sr = read_wav(path)
        orig_cache[audio_input] = (aud, sr)
        return orig_cache[audio_input]

    def process(method_name: str, items):
        for audio_input, src, tar, skip, tarcfg, srccfg, path in items:
            rec = ScoreRecord(method_name, audio_input, src, tar,
                              skip, tarcfg, srccfg, path=path)
            if rec.key() in state.records and \
                    state.records[rec.key()].clap is not None:
                continue
            aud, sr = read_wav(path)
            rec.clap = clap.windowed(aud, sr, tar, win_length, overlap, method)
            orig = orig_for(audio_input, path)
            if orig is not None:
                rec.lpaps = lpaps.windowed(aud, orig[0], sr, orig[1],
                                           win_length, overlap, method)
            state.records[rec.key()] = rec
            if verbose:
                print(f"[evals] {method_name} {audio_input} '{tar}' "
                      f"clap={rec.clap:.4f} lpaps={rec.lpaps}")
            if prev_pt:
                state.save(prev_pt)

    for root in (ours_dirs or []):
        process("ours", _iter_ours(root))
    for root in (ddim_dirs or []):
        process("ddim", _iter_ours(root))
    for root in (sdedit_dirs or []):
        process("sdedit", _iter_sdedit(root))
    # MusicGen / MusicGen-large baseline lanes (reference CombinedRes
    # includes both, evals/utils.py:14-20, 123-138)
    for root in (musicgen_dirs or []):
        process("musicgen", _iter_musicgen(root))
    for root in (musicgen_large_dirs or []):
        process("musicgen_large", _iter_musicgen(root))
    if prev_pt:
        state.save(prev_pt)
    return state


def combine_scores(state: ScoreState) -> Dict[str, Table]:
    """A table per method, in method order, without the method column
    (reference: evals/utils.py combine_scores)."""
    table = Table.from_records([vars(r) for r in state.records.values()])
    if not len(table):
        return {}
    m = table.columns.index("method")
    columns = table.columns[:m] + table.columns[m + 1:]
    out = {}
    for method in sorted(set(table.column("method"))):
        out[method] = Table(columns, [r[:m] + r[m + 1:] for r in table.rows if r[m] == method])
    return out


def _group_key(x):
    """A sort key of a group value: missing values last, as pandas sorts."""
    return (1, 0) if is_missing(x) else (0, x)


def _stats(values: Sequence[Any]):
    """(mean, sample std, count) of the values that are not missing."""
    xs = np.asarray([v for v in values if not is_missing(v)], np.float64)
    n = len(xs)
    mean = float(xs.mean()) if n else float("nan")
    std = float(xs.std(ddof=1)) if n > 1 else float("nan")
    return mean, std, n


def supervised_tradeoff_table(df: Table, group_by=("skip", "tarcfg", "srccfg")) -> Table:
    """CLAP-vs-LPAPS trade-off curves, aggregated over inputs and prompts
    per sweep point: the table behind evals/SupEval.ipynb cells 10-14 (mean,
    std and count of CLAP and LPAPS per skip x tarcfg x srccfg), sorted by
    the sweep columns with missing values last."""
    cols = [c for c in group_by if c in df.columns]
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for rec in df.records():
        key = tuple(None if is_missing(rec[c]) else rec[c] for c in cols)
        groups.setdefault(key, []).append(rec)
    rows = []
    for key in sorted(groups, key=lambda k: tuple(_group_key(x) for x in k)):
        row = list(key)
        for metric in ("clap", "lpaps"):
            row += _stats([rec[metric] for rec in groups[key]])
        rows.append(row)
    names = [f"{m}_{s}" for m in ("clap", "lpaps") for s in ("mean", "std", "count")]
    return Table(cols + names, rows)


def method_comparison_table(dfs: Dict[str, Table]) -> Table:
    """One table across all method lanes, each lane's trade-off rows under
    its name: the side-by-side comparison behind the paper's supervised
    table. Sweep columns stay where a lane has them and are missing where it
    has none (flat baselines)."""
    parts = [(method, supervised_tradeoff_table(df)) for method, df in dfs.items()]
    if not parts:
        return Table(["method"])
    columns = ["method"]
    for _, t in parts:
        columns += [c for c in t.columns if c not in columns]
    records = [{"method": method, **rec} for method, t in parts for rec in t.records()]
    cols = [_promote([rec.get(c) for rec in records]) for c in columns]
    return Table(columns, [list(r) for r in zip(*cols)])


def unsupervised_fad_table(fad_by_skip: Dict[int, Dict[str, float]]) -> Table:
    """FAD-to-original vs FAD-to-reference-set scatter data per skip:
    evals/UnsupEval.ipynb cell 16. Input: {skip: {ref_name: fad}}."""
    return Table.from_records([{"skip": skip, **refs}
                               for skip, refs in sorted(fad_by_skip.items())])
