"""MedleyMDPrompts dataset loader (a copy of ``audioeditingcode_tpu/data/medley.py``
with its own vendored CSVs).

Reader for the prompt dataset the reference ships and evaluates on
(reference: MedleyMDPrompts/captions_sources.csv — columns
``filename, source_captions``; captions_targets.csv — ``filename,
target_captions, can_be_used_without_source, source_caption_index``;
documented in README.md:116-121): 107 source + 696 target prompts for 34
MusicDelta excerpts. The CC-BY-licensed CSVs are vendored in
``MedleyMDPrompts/`` next to this module (see ATTRIBUTION.md), so the
eval sweep is self-serving; pass explicit paths to use another checkout.

``iter_edit_pairs`` yields the (source_prompt, target_prompt) combinations
used by the supervised evaluation sweep: every target is paired with its
annotated source caption(s), and targets flagged
``can_be_used_without_source`` additionally pair with the empty source.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple


@dataclasses.dataclass(frozen=True)
class MedleyPrompt:
    filename: str
    target_caption: str
    can_be_used_without_source: bool
    source_caption_index: Tuple[int, ...]  # 1-based indices into the sources


VENDORED_DIR = os.path.join(os.path.dirname(__file__), "MedleyMDPrompts")
DEFAULT_SOURCES_CSV = os.path.join(VENDORED_DIR, "captions_sources.csv")
DEFAULT_TARGETS_CSV = os.path.join(VENDORED_DIR, "captions_targets.csv")


def load_medley_prompts(
    sources_csv: str = DEFAULT_SOURCES_CSV,
    targets_csv: str = DEFAULT_TARGETS_CSV,
) -> Tuple[Dict[str, List[str]], List[MedleyPrompt]]:
    """Returns (sources: filename -> [source captions], targets)."""
    sources: Dict[str, List[str]] = defaultdict(list)
    with open(sources_csv, newline="") as f:
        for row in csv.DictReader(f):
            sources[row["filename"]].append(row["source_captions"])

    targets: List[MedleyPrompt] = []
    with open(targets_csv, newline="") as f:
        for row in csv.DictReader(f):
            idx_field = str(row.get("source_caption_index", "") or "").strip()
            idxs = tuple(
                int(x) for x in idx_field.replace(";", ",").split(",") if x.strip()
            )
            targets.append(
                MedleyPrompt(
                    filename=row["filename"],
                    target_caption=row["target_captions"],
                    can_be_used_without_source=str(
                        row.get("can_be_used_without_source", "0")
                    ).strip() in ("1", "True", "true"),
                    source_caption_index=idxs,
                )
            )
    return dict(sources), targets


def iter_edit_pairs(
    sources: Dict[str, List[str]],
    targets: List[MedleyPrompt],
    include_empty_source: bool = True,
) -> Iterator[Tuple[str, str, str]]:
    """Yield (filename, source_prompt, target_prompt) evaluation pairs."""
    for t in targets:
        caps = sources.get(t.filename, [])
        for i in t.source_caption_index:
            if 1 <= i <= len(caps):
                yield t.filename, caps[i - 1], t.target_caption
        if include_empty_source and t.can_be_used_without_source:
            yield t.filename, "", t.target_caption
