"""Evaluation runner CLI on PyTorch.

Counterpart of ``audioeditingcode_tpu/cli/evals_run.py`` (``main_evals.py``):
the script form of the reference's evaluation notebooks (evals/SupEval.ipynb,
windowed CLAP/LPAPS sweep tables; evals/UnsupEval.ipynb, FAD of generation
directories against originals and a reference set), with the same flags
and output files (``scores_<method>.csv``, ``method_comparison.csv``,
``fad_by_skip.csv``, ``fad.json``, the figures with ``--plots``), plus
``--device`` and ``--device_num``. Run it as ``aetorch-evals`` or ``python -m
audioeditingcode_tpu_torch.cli.evals_run``. The CLAP towers run on the CUDA
card ``--device_num`` unless ``--device cpu`` is given; a missing card is
an error. It scores the results trees that the port's edit CLIs write
(``cli/run.py``, ``cli/run_batch.py``, ``cli/sdedit.py``).
"""

from __future__ import annotations

import argparse
import json
import os

from ..evals.fad import FADScorer
from ..evals.features import default_extractor, fad_extractor
from ..evals.scores import (calc_scores, combine_scores, method_comparison_table,
                            unsupervised_fad_table)
from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compute CLAP/LPAPS/FAD scores")
    p.add_argument("--ours_dirs", type=str, nargs="*", default=[],
                   help="result roots at the <model> level (cli/run.py layout)")
    p.add_argument("--sdedit_dirs", type=str, nargs="*", default=[])
    p.add_argument("--ddim_dirs", type=str, nargs="*", default=[])
    p.add_argument("--musicgen_dirs", type=str, nargs="*", default=[],
                   help="MusicGen baseline roots: <root>/<input>/prompt_<target prompt>.wav "
                        "(reference evals/utils.py:211-216)")
    p.add_argument("--musicgen_large_dirs", type=str, nargs="*", default=[],
                   help="MusicGen-large baseline roots (same layout)")
    p.add_argument("--inputs_orig", type=str, default=None,
                   help="directory of original input wavs (else sibling orig.wav)")
    p.add_argument("--fad_gen_dir", type=str, default=None, help="generation dir for FAD")
    p.add_argument("--fad_gen_dirs", type=str, nargs="*", default=[], metavar="SKIP=DIR",
                   help="per-skip generation dirs (e.g. 150=out/skip150) for the "
                        "UnsupEval FAD-vs-FAD sweep table/scatter")
    p.add_argument("--fad_ref_dirs", type=str, nargs="*", default=[],
                   help="reference dirs for FAD (e.g. originals, FMA-pop); the FIRST is "
                        "the originals axis of the scatter (reference UnsupEval.ipynb "
                        "cell 16)")
    p.add_argument("--clap_model", type=str, default=None,
                   help="checkpoint directory or id of a CLAP checkpoint (an id names "
                        "checkpoints/<id>/ in the repository); defaults to the reference "
                        "LPAPS/consistency protocol checkpoint "
                        "(laion/larger_clap_music_and_speech)")
    p.add_argument("--clap_backend", type=str, default="jax", choices=["jax", "torch"],
                   help="jax: the port's CLAP towers (the counterpart of the JAX tower) "
                        "on --device; torch: the transformers oracle on the CPU")
    p.add_argument("--allow_mel_fallback", action="store_true",
                   help="if the CLAP checkpoint is unreachable, knowingly fall back to the "
                        "weight-free, NON-perceptual mel extractor instead of erroring "
                        "(scores are then not protocol-comparable)")
    p.add_argument("--prev_pt", type=str, default=None,
                   help="scores checkpoint (resume support)")
    p.add_argument("--win_length", type=float, default=None)
    p.add_argument("--overlap", type=float, default=0.1)
    p.add_argument("--method", type=str, default="mean",
                   choices=["mean", "median", "max", "min"])
    p.add_argument("--out_dir", type=str, default="eval_scores")
    p.add_argument("--plots", action="store_true",
                   help="render the notebook figures next to the CSVs: CLAP-vs-LPAPS "
                        "trade-off curves per sweep dim (SupEval cells 10-14) and the FAD "
                        "scatter (UnsupEval cell 16)")
    p.add_argument("--total_steps", type=int, default=200,
                   help="diffusion steps of the evaluated runs; used only to annotate "
                        "plot points with tstart = steps - skip")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run the CLAP towers on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    return p


def _ref_name(i: int, ref_dir: str) -> str:
    """Column name of a FAD reference set: the first is the originals axis
    (``orig``), the others keep their directory name."""
    if i == 0:
        return "orig"
    return os.path.basename(os.path.normpath(ref_dir)) or f"ref{i}"


def _ref_names(ref_dirs) -> list:
    """Unique column names for --fad_ref_dirs: two reference dirs sharing a
    basename get index-suffixed names."""
    names = []
    for i, ref in enumerate(ref_dirs):
        name = _ref_name(i, ref)
        if name in names:
            name = f"{name}#{i}"
        names.append(name)
    return names


def _bind_fad_scorer(args, extractor, device):
    """FAD scorer bound to the reference protocol (the fadtk
    clap-laion-music checkpoint) unless --clap_model overrides it. Returns
    (scorer, extractor), so that an extractor built here is reused."""
    if args.clap_model:
        if extractor is None:
            extractor = default_extractor(args.clap_model, backend=args.clap_backend,
                                          allow_mel_fallback=args.allow_mel_fallback,
                                          device=device)
        fad_ext = extractor
    else:
        fad_ext = fad_extractor(backend=args.clap_backend,
                                allow_mel_fallback=args.allow_mel_fallback, device=device)
    return FADScorer(fad_ext, window_size_s=args.win_length or 10.0,
                     overlap=args.overlap), extractor


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, args.device_num)
    os.makedirs(args.out_dir, exist_ok=True)
    outputs = []
    # the LPAPS/consistency extractor is built only when needed: a FAD-only
    # run does not load the LPAPS protocol checkpoint
    extractor = None

    if (args.ours_dirs or args.sdedit_dirs or args.ddim_dirs
            or args.musicgen_dirs or args.musicgen_large_dirs):
        extractor = default_extractor(args.clap_model, backend=args.clap_backend,
                                      allow_mel_fallback=args.allow_mel_fallback,
                                      device=device)
        state = calc_scores(
            extractor, ours_dirs=args.ours_dirs, sdedit_dirs=args.sdedit_dirs,
            ddim_dirs=args.ddim_dirs, musicgen_dirs=args.musicgen_dirs,
            musicgen_large_dirs=args.musicgen_large_dirs, inputs_orig=args.inputs_orig,
            prev_pt=args.prev_pt, win_length=args.win_length, overlap=args.overlap,
            method=args.method,
        )
        dfs = combine_scores(state)
        for name, df in dfs.items():
            out = os.path.join(args.out_dir, f"scores_{name}.csv")
            df.to_csv(out)
            outputs.append(out)
            print(f"[+] wrote {out} ({len(df)} rows)")
        if len(dfs) > 1:
            out = os.path.join(args.out_dir, "method_comparison.csv")
            method_comparison_table(dfs).to_csv(out)
            outputs.append(out)
            print(f"[+] wrote {out}")
        if args.plots and dfs:
            from ..evals.figures import save_eval_figures

            for fig_path in save_eval_figures(dfs, args.out_dir, total_steps=args.total_steps):
                outputs.append(fig_path)
                print(f"[+] wrote {fig_path}")

    fad_scorer = None
    if args.fad_gen_dirs:
        if not args.fad_ref_dirs:
            raise SystemExit("--fad_gen_dirs needs --fad_ref_dirs")
        fad_scorer, extractor = _bind_fad_scorer(args, extractor, device)
        ref_names = _ref_names(args.fad_ref_dirs)
        by_skip = {}
        for spec in args.fad_gen_dirs:
            skip_s, _, gen_dir = spec.partition("=")
            if not gen_dir or not skip_s.isdigit():
                raise SystemExit(f"--fad_gen_dirs wants SKIP=DIR, got {spec!r}")
            skip = int(skip_s)
            if skip in by_skip:
                raise SystemExit(f"--fad_gen_dirs has skip {skip} twice")
            by_skip[skip] = {name: fad_scorer.score_dirs(gen_dir, ref)
                             for name, ref in zip(ref_names, args.fad_ref_dirs)}
        fad_df = unsupervised_fad_table(by_skip)
        out = os.path.join(args.out_dir, "fad_by_skip.csv")
        fad_df.to_csv(out)
        outputs.append(out)
        print(f"[+] wrote {out}")
        if args.plots:
            from ..evals.figures import save_eval_figures

            for fig_path in save_eval_figures({}, args.out_dir, fad_df=fad_df,
                                              total_steps=args.total_steps):
                outputs.append(fig_path)
                print(f"[+] wrote {fig_path}")

    if args.fad_gen_dir:
        if fad_scorer is None:
            fad_scorer, extractor = _bind_fad_scorer(args, extractor, device)
        fads = {ref: fad_scorer.score_dirs(args.fad_gen_dir, ref) for ref in args.fad_ref_dirs}
        out = os.path.join(args.out_dir, "fad.json")
        with open(out, "w") as f:
            json.dump(fads, f, indent=2)
        outputs.append(out)
        print(f"[+] wrote {out}: {fads}")

    return outputs


if __name__ == "__main__":
    main()
