"""The real-weight runbook on PyTorch, as one command.

Counterpart of ``tools/validate_real_weights.py``, with the same steps,
method lanes, flags, work-dir layout, step lines and exit codes, plus
``--device`` (default ``cuda``) and ``--device_num``. Each step calls the
port's own tool; nothing of JAX, flax or transformers is needed. Run it as
``aetorch-validate`` or ``python -m
audioeditingcode_tpu_torch.cli.validate_real_weights``:

  1. fetch      takes ``--src`` (a checkpoint directory in the diffusers
                pipeline layout), or downloads ``--model_id`` with
                ``huggingface_hub.snapshot_download`` where that package is
                installed (else the step fails and names it)
  2. manifest   holds the checkpoint's state-dict keys and shapes to the
                vendored manifests (``data/key_manifests``; the safetensors
                headers alone are read), so that upstream drift fails
                before conversion
  3. convert    ``cli/convert_checkpoint.py`` into ``weights/<slug>``; the
                port's converter is strict, so a missing tensor fails here,
                named, where the JAX converter fills it at random
  4. selfcheck  ``cli/run.py --selfcheck`` on the converted weights; the
                latent reconstruction SNR must reach ``--min_snr_db``
                (40 dB by default)
  5. edit       one text edit per method lane (``--methods
                ours[,ddim,sdedit]``: ``cli/run.py`` and ``cli/sdedit.py``),
                each wav finite and not silent
  6. evals      ``cli/evals_run.py --plots`` over every lane (the figures
                need matplotlib; pass ``--allow_mel_fallback`` only where
                the CLAP checkpoint itself is unreachable)
  7. page       ``cli/demo_page.py`` writes ``supp.html``, one column per
                lane, the wavs copied under ``audio/``

Each step prints ``[i/n] step: PASS|SKIP|FAIL (Ns): ...``; the run stops
at the first failure with exit code 1. The edits run on the CUDA card
``--device_num`` unless ``--device cpu`` is given; a missing card fails
the step, never a silent CPU run. Typical use, once a checkpoint is on
the card's machine::

  aetorch-validate --model_id cvssp/audioldm2-music --src /data/audioldm2-music \\
      --work_dir /data/aec --audio my_clip.wav \\
      --target_prompt "a jazzy saxophone solo" --methods ours,ddim,sdedit

``--steps`` runs a subset (e.g. ``--steps manifest,convert``, which needs
``--src``). A rehearsal on a synthetic checkpoint gives the page an
unmissable banner: ``--banner "SYNTHETIC WEIGHTS"``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

STEPS = ["fetch", "manifest", "convert", "selfcheck", "edit", "evals", "page"]
METHODS = ["ours", "ddim", "sdedit"]
MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "key_manifests")

# the text towers' subfolders have no manifest, and GPT-2's attention bias
# buffers are not persistent in newer dumps
_SKIP_KEY = re.compile(r"\.attn\.(bias|masked_bias)$")


def _canonical(key: str) -> str:
    """A legacy diffusers / torch key in the manifests' spelling (the
    renames the converter applies)."""
    k = key
    # the legacy VAE mid-block attention -> to_q/to_k/to_v/to_out.0
    k = re.sub(r"\.query\.(weight|bias)$", r".to_q.\1", k)
    k = re.sub(r"\.key\.(weight|bias)$", r".to_k.\1", k)
    k = re.sub(r"\.value\.(weight|bias)$", r".to_v.\1", k)
    k = re.sub(r"\.proj_attn\.(weight|bias)$", r".to_out.0.\1", k)
    # torch's parametrized weight norm -> the weight_g/weight_v pair
    k = re.sub(r"\.parametrizations\.weight\.original0$", ".weight_g", k)
    k = re.sub(r"\.parametrizations\.weight\.original1$", ".weight_v", k)
    return k


class Ctx:
    def __init__(self, args):
        self.args = args
        self.src = args.src
        self.weights_dir = os.path.join(args.work_dir, "weights",
                                        args.model_id.replace("/", "__"))
        # one results root per method lane: the evals CLI and the page take
        # one root per lane
        self.results_dir = os.path.join(args.work_dir, "results")
        self.lane_dirs = {
            "ours": self.results_dir,
            "ddim": os.path.join(args.work_dir, "results_ddim"),
            "sdedit": os.path.join(args.work_dir, "results_sdedit"),
        }
        self.methods = [m.strip() for m in args.methods.split(",") if m.strip()]
        self.eval_dir = os.path.join(args.work_dir, "eval_scores")
        self.lane_wavs = {}
        self.audio = args.audio

    def lane_model_root(self, method: str) -> str:
        return os.path.join(self.lane_dirs[method], self.args.model_id.split("/")[-1])

    def device_argv(self) -> list:
        return ["--device", self.args.device, "--device_num", str(self.args.device_num)]


def step_fetch(ctx: Ctx) -> str:
    if ctx.src:
        if not os.path.isdir(ctx.src):
            raise RuntimeError(f"--src {ctx.src} is not a directory")
        return f"using local checkpoint {ctx.src}"
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        raise RuntimeError("no huggingface_hub package to download with: copy the "
                           "checkpoint to this machine and pass --src") from None

    ctx.src = snapshot_download(ctx.args.model_id)
    return f"downloaded to {ctx.src}"


def read_manifest(path: str) -> dict:
    """{key: shape} of one vendored manifest file (``<key>\t<d0,d1,...>``
    lines, ``#`` comments)."""
    want = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            k, s = line.rstrip("\n").split("\t")
            want[k] = tuple(int(x) for x in s.split(",") if x)
    return want


def step_manifest(ctx: Ctx) -> str:
    from ..models.hf_checkpoint import read_shapes

    mdir = os.path.join(MANIFEST_DIR, ctx.args.model_id.replace("/", "__"))
    if not os.path.isdir(mdir):
        return f"SKIP: no vendored manifest for {ctx.args.model_id}"
    problems, checked = [], 0
    for fname in sorted(os.listdir(mdir)):
        if not fname.endswith(".txt"):
            continue
        comp = fname[:-4]
        want = read_manifest(os.path.join(mdir, fname))
        d = os.path.join(ctx.src, comp)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"missing checkpoint subfolder: {d}")
        got = {_canonical(k): s for k, s in read_shapes(d).items() if not _SKIP_KEY.search(k)}
        missing = sorted(set(want) - set(got))
        unexpected = sorted(set(got) - set(want))
        bad_shape = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        for name, lst in (("missing", missing), ("unexpected", unexpected),
                          ("shape-mismatch", bad_shape)):
            if lst:
                problems.append(f"{comp}: {len(lst)} {name} (e.g. {lst[:3]})")
        checked += len(want)
    if problems:
        raise RuntimeError("checkpoint drifted from vendored manifests: " + "; ".join(problems))
    return f"{checked} tensors match the vendored manifests"


def step_convert(ctx: Ctx) -> str:
    from .convert_checkpoint import convert

    os.makedirs(ctx.weights_dir, exist_ok=True)
    convert(ctx.args.model_id, ctx.src, ctx.weights_dir)
    return f"converted into {ctx.weights_dir}"


def _ensure_audio(ctx: Ctx) -> str:
    if ctx.audio:
        return ctx.audio
    # a synthesized clip keeps the runbook self-contained
    import numpy as np

    from ..utils.audio_io import write_wav

    sr = 44100 if "stable-audio" in ctx.args.model_id else 16000
    t = np.arange(int(sr * ctx.args.audio_seconds), dtype=np.float32) / sr
    wav = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.2 * np.sin(2 * np.pi * 495 * t)
    path = os.path.join(ctx.args.work_dir, "probe_clip.wav")
    write_wav(path, wav[None], sr)
    ctx.audio = path
    return path


def _run_edit(ctx: Ctx, selfcheck: bool, mode: str = "ours") -> str:
    from .run import main as run_main

    argv = [
        "--model_id", ctx.args.model_id,
        "--init_aud", _ensure_audio(ctx),
        "--target_prompt", ctx.args.target_prompt,
        "--num_diffusion_steps", str(ctx.args.num_diffusion_steps),
        "--tstart", str(ctx.args.tstart),
        "--results_path", ctx.lane_dirs[mode],
        "--weights_dir", ctx.weights_dir,
        "--mode", mode,
        "--seed", "0",
    ] + ctx.device_argv()
    if ctx.args.source_prompt:
        argv += ["--source_prompt", ctx.args.source_prompt]
    if selfcheck:
        argv += ["--selfcheck"]
    return run_main(argv)


def _run_sdedit(ctx: Ctx) -> str:
    from .sdedit import main as sdedit_main

    return sdedit_main([
        "--model_id", ctx.args.model_id,
        "--init_aud", _ensure_audio(ctx),
        "--target_prompt", ctx.args.target_prompt,
        "--num_diffusion_steps", str(ctx.args.num_diffusion_steps),
        "--tstart", str(ctx.args.tstart),
        "--results_path", ctx.lane_dirs["sdedit"],
        "--weights_dir", ctx.weights_dir,
        "--seed", "0",
        "--wandb_disable",
    ] + ctx.device_argv())


def step_selfcheck(ctx: Ctx) -> str:
    out_wav = _run_edit(ctx, selfcheck=True)
    run_args = os.path.join(os.path.dirname(out_wav), "run_args.json")
    with open(run_args) as f:
        snr = json.load(f).get("selfcheck_snr_db")
    if snr is None:
        raise RuntimeError(f"no selfcheck_snr_db recorded in {run_args}")
    if snr < ctx.args.min_snr_db:
        raise RuntimeError(
            f"selfcheck SNR {snr:.1f} dB < {ctx.args.min_snr_db} dB — "
            "weights/converter/schedule disagree (see PARITY.md)")
    return f"latent reconstruction SNR {snr:.1f} dB (>= {ctx.args.min_snr_db})"


def step_edit(ctx: Ctx) -> str:
    import numpy as np

    from ..utils.audio_io import read_wav

    for method in ctx.methods:
        if method == "sdedit":
            wav_path = _run_sdedit(ctx)
        else:
            wav_path = _run_edit(ctx, selfcheck=False, mode=method)
        wav, _ = read_wav(wav_path)
        if not np.isfinite(wav).all() or float(np.abs(wav).max()) < 1e-5:
            raise RuntimeError(f"{method} edit output degenerate: {wav_path}")
        ctx.lane_wavs[method] = wav_path
    lanes = ", ".join(f"{m}: {p}" for m, p in ctx.lane_wavs.items())
    return (f"edits written ({len(ctx.lane_wavs)} lane"
            f"{'s' if len(ctx.lane_wavs) > 1 else ''}): {lanes}")


def step_evals(ctx: Ctx) -> str:
    from .evals_run import main as evals_main

    argv = ["--out_dir", ctx.eval_dir, "--plots"] + ctx.device_argv()
    lane_flags = {"ours": "--ours_dirs", "ddim": "--ddim_dirs", "sdedit": "--sdedit_dirs"}
    for method in ctx.methods:
        argv += [lane_flags[method], ctx.lane_model_root(method)]
    if ctx.args.allow_mel_fallback:
        argv += ["--allow_mel_fallback"]
    outputs = evals_main(argv)
    if not outputs:
        raise RuntimeError("evals produced no outputs")
    return f"scored: {', '.join(os.path.basename(o) for o in outputs)}"


def step_page(ctx: Ctx) -> str:
    from .demo_page import main as page_main

    out = os.path.join(ctx.args.work_dir, "supp.html")
    # the page scans a results ROOT (<root>/<model>/<clip>/...), not the
    # per-model directory the evals CLI takes. The primary column is the
    # first requested lane that has a root: with --methods ddim there is
    # no ours root to scan.
    primary = next((m for m in ctx.methods if os.path.isdir(ctx.lane_dirs[m])), None)
    if primary is None:
        raise RuntimeError(
            f"no results root exists for any requested method "
            f"({', '.join(ctx.methods)}); run the edit step first")
    argv = ["--results", ctx.lane_dirs[primary], "--out", out,
            "--copy-audio", os.path.join(ctx.args.work_dir, "audio")]
    if "sdedit" in ctx.methods and primary != "sdedit":
        argv += ["--sdedit", ctx.lane_dirs["sdedit"]]
    if "ddim" in ctx.methods and primary != "ddim":
        argv += ["--ddim", ctx.lane_dirs["ddim"]]
    if ctx.args.banner:
        argv += ["--banner", ctx.args.banner]
    page_main(argv)
    if not os.path.exists(out):
        raise RuntimeError("demo page not written")
    lanes = "/".join(ctx.methods)
    return f"demo page rebuilt ({lanes} lanes): {out}"


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_id", required=True)
    p.add_argument("--src", default=None,
                   help="already-downloaded checkpoint dir (skips download)")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--audio", default=None,
                   help="input clip (default: a synthesized probe tone)")
    p.add_argument("--audio_seconds", type=float, default=10.0)
    p.add_argument("--target_prompt", default="a jazzy saxophone solo")
    p.add_argument("--source_prompt", default="")
    p.add_argument("--num_diffusion_steps", type=int, default=50,
                   help="50 keeps the runbook fast; use 200 for "
                        "reference-default quality evidence")
    p.add_argument("--tstart", type=int, default=25)
    p.add_argument("--min_snr_db", type=float, default=40.0)
    p.add_argument("--methods", default="ours",
                   help=f"comma subset of {','.join(METHODS)}: method lanes "
                        "for the edit/evals/page steps")
    p.add_argument("--banner", default=None,
                   help="provenance banner rendered at the top of the demo "
                        "page (e.g. 'SYNTHETIC WEIGHTS' for a rehearsal)")
    p.add_argument("--allow_mel_fallback", action="store_true",
                   help="pass through to the evals CLI when the CLAP "
                        "protocol checkpoint is unreachable")
    p.add_argument("--steps", default=",".join(STEPS),
                   help=f"comma subset of {','.join(STEPS)}")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run the edits and evals on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    wanted = [s.strip() for s in args.steps.split(",") if s.strip()]
    unknown = [s for s in wanted if s not in STEPS]
    if unknown:
        raise SystemExit(f"unknown steps: {unknown} (know {STEPS})")
    bad_methods = [m for m in args.methods.split(",")
                   if m.strip() and m.strip() not in METHODS]
    if bad_methods:
        raise SystemExit(f"unknown methods: {bad_methods} (know {METHODS})")
    if ("fetch" not in wanted and args.src is None
            and any(s in wanted for s in ("manifest", "convert"))):
        raise SystemExit("--steps skips 'fetch', so --src (the downloaded "
                         "checkpoint directory) is required for "
                         "manifest/convert")
    os.makedirs(args.work_dir, exist_ok=True)
    ctx = Ctx(args)
    fns = {"fetch": step_fetch, "manifest": step_manifest,
           "convert": step_convert, "selfcheck": step_selfcheck,
           "edit": step_edit, "evals": step_evals, "page": step_page}
    ordered = [s for s in STEPS if s in wanted]
    for i, name in enumerate(ordered, 1):
        t0 = time.time()
        tag = f"[{i}/{len(ordered)}] {name}"
        try:
            msg = fns[name](ctx)
        # SystemExit included: the nested CLIs exit that way (argparse, the
        # evals CLI), and the contract is a FAIL line and a stop
        except (Exception, SystemExit) as e:  # noqa: BLE001 — report, stop
            print(f"{tag}: FAIL ({time.time() - t0:.0f}s): {e}")
            return 1
        status = "SKIP" if msg.startswith("SKIP") else "PASS"
        print(f"{tag}: {status} ({time.time() - t0:.0f}s): {msg}")
    print(f"[validate] {args.model_id}: all requested steps passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
