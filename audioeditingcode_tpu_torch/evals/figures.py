"""Eval figures: script form of the reference notebooks' plots.

Counterpart of ``audioeditingcode_tpu/evals/figures.py``, on the tables of
``evals/scores.py``: the CLAP-vs-LPAPS trade-off curves per method across
the skip/tarcfg/srccfg sweeps (reference evals/SupEval.ipynb cells 10-14)
and the FAD-to-original vs FAD-to-reference-set scatter across skips
(reference evals/UnsupEval.ipynb cell 16), written next to the score CSVs
by ``cli/evals_run.py --plots``. matplotlib is imported when a figure is
drawn; where it is missing, that raises an ImportError that names it.

Axes (the reference's): CLAP similarity to the target prompt on x (higher
is better), LPAPS distance to the source on y (lower is better); sweep
points are annotated with tstart = total_steps - skip.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Optional

import numpy as np

from .scores import Table, is_missing

_METHOD_STYLE = {
    "ours": dict(marker="*", markersize=10, linewidth=2),
    "sdedit": dict(marker="o", markersize=7, linewidth=1.5),
    "ddim": dict(marker="s", markersize=6, linewidth=1.5),
    "musicgen": dict(marker="D", markersize=8),
    "musicgen-large": dict(marker="P", markersize=9),
    "orig": dict(marker="v", markersize=7),
}
_SWEEP_DIMS = ("skip", "tarcfg", "srccfg")


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--plots needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _present(table: Table, col: str):
    return [v for v in table.column(col) if not is_missing(v)] if col in table.columns else []


def _mean(values) -> float:
    xs = [v for v in values if not is_missing(v)]
    return float(np.mean(xs)) if xs else float("nan")


def _dominant(table: Table, col: str):
    """Most frequent value of a sweep column, the smallest of a tie (the
    data-driven analogue of the notebook's fixed srccfg=3 / tarcfg=12)."""
    counts = Counter(_present(table, col))
    if not counts:
        return None
    top = max(counts.values())
    return min(v for v, n in counts.items() if n == top)


def _curve(table: Table, sweep: str, fixed: dict):
    """[(sweep value, mean clap, mean lpaps)] in sweep order, over the rows
    at the fixed values of the other sweep dims: SupEval's per-curve
    selection."""
    def keep(rec):
        for col, val in fixed.items():
            if col in rec and val is not None and not (
                    not is_missing(rec[col]) and np.isclose(float(rec[col]), float(val))):
                return False
        return sweep in rec and not is_missing(rec[sweep])

    if sweep not in table.columns:
        return None
    groups: Dict = {}
    for rec in table.where(keep).records():
        groups.setdefault(rec[sweep], []).append(rec)
    return [(v, _mean(r["clap"] for r in groups[v]), _mean(r["lpaps"] for r in groups[v]))
            for v in sorted(groups)] or None


def _is_flat(table: Table, sweep: str) -> bool:
    """A lane without a sweep column (MusicGen baselines) plots as a point."""
    return len(set(_present(table, sweep))) <= 1


def tradeoff_figure(dfs: Dict[str, Table], sweep: str = "skip",
                    fixed: Optional[dict] = None, total_steps: int = 200):
    """CLAP-vs-LPAPS trade-off figure for one sweep dimension; flat lanes
    are single points. Returns the matplotlib Figure, or None when nothing
    plots."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    plotted = 0
    for method, df in dfs.items():
        if df is None or not len(df):
            continue
        style = _METHOD_STYLE.get(method, dict(marker="^", markersize=6))
        if _is_flat(df, sweep):
            ax.plot(_mean(df.column("clap")), _mean(df.column("lpaps")), linestyle="none",
                    label=method, **style)
            plotted += 1
            continue
        own_fixed = {c: (fixed or {}).get(c, _dominant(df, c)) for c in _SWEEP_DIMS if c != sweep}
        curve = _curve(df, sweep, own_fixed)
        if not curve:
            continue
        ax.plot([c[1] for c in curve], [c[2] for c in curve], label=method, **style)
        for v, clap, lpaps in curve:
            label = f"{int(total_steps - v)}" if sweep == "skip" else f"{v:g}"
            ax.annotate(label, (clap, lpaps), textcoords="offset points", xytext=(5, 4),
                        fontsize=8)
        plotted += 1
    if not plotted:
        plt.close(fig)
        return None
    ax.set_xlabel("CLAP similarity to target prompt (higher is better)")
    ax.set_ylabel("LPAPS distance to source (lower is better)")
    name = {"skip": f"tstart sweep (labels = tstart of {total_steps})",
            "tarcfg": "target-CFG sweep", "srccfg": "source-CFG sweep"}[sweep]
    ax.set_title(f"Edit fidelity trade-off — {name}")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    return fig


def fad_scatter_figure(fad_df: Optional[Table], x_col: str = "orig",
                       y_col: Optional[str] = None, total_steps: int = 200,
                       label: str = "generated"):
    """FAD-to-original (x) vs FAD-to-reference-set (y) across skips, from
    ``scores.unsupervised_fad_table``'s table."""
    if fad_df is None or not len(fad_df) or x_col not in fad_df.columns:
        return None
    if y_col is None:
        y_col = next((c for c in fad_df.columns if c not in ("skip", x_col)), None)
    if y_col is None:
        return None
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    recs = sorted(fad_df.records(), key=lambda r: r["skip"])
    ax.plot([r[x_col] for r in recs], [r[y_col] for r in recs], marker="o", markersize=9,
            linewidth=2, label=label)
    for r in recs:
        ax.annotate(f"{int(total_steps - r['skip'])}", (r[x_col], r[y_col]),
                    textcoords="offset points", xytext=(6, -4), fontsize=8)
    ax.set_xlabel(f"FAD to original recordings ({x_col})")
    ax.set_ylabel(f"FAD to reference set ({y_col})")
    ax.set_title(f"Unsupervised editing FAD trade-off (labels = tstart of {total_steps})")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    return fig


def save_eval_figures(dfs: Dict[str, Table], out_dir: str, fad_df: Optional[Table] = None,
                      total_steps: int = 200) -> list:
    """Render every producible figure into out_dir; returns the written
    paths: one trade-off PNG per sweep dimension that varies in the 'ours'
    lane (skip always), and the FAD scatter when a per-skip FAD table is
    given."""
    plt = _plt()
    written = []
    ours = dfs.get("ours") if dfs else None
    for sweep in _SWEEP_DIMS:
        has_sweep = ours is not None and len(ours) and not _is_flat(ours, sweep)
        if not has_sweep and sweep != "skip":
            continue
        fig = tradeoff_figure(dfs, sweep=sweep, total_steps=total_steps)
        if fig is None:
            continue
        path = os.path.join(out_dir, f"tradeoff_{sweep}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    if fad_df is not None:
        fig = fad_scatter_figure(fad_df, total_steps=total_steps)
        if fig is not None:
            path = os.path.join(out_dir, "fad_scatter.png")
            fig.savefig(path, dpi=120)
            plt.close(fig)
            written.append(path)
    return written
