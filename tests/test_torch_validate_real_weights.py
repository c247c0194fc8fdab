"""The port's real-weight runbook (cli/validate_real_weights.py,
``aetorch-validate``) on the CPU, against the JAX package's
tools/validate_real_weights.py.

Every case of tests/test_validate_real_weights.py, run on the port with
``--device cpu`` on the same fake checkpoint (tests/test_convert_integration:
the tiny AudioLDM's unet/vae/vocoder named after the JAX package's Flax
modules, a transformers CLAP text tower and an offline RoBERTa tokenizer);
then the two tools' step lines on that checkpoint, equal with the seconds,
the paths and the wav timestamps masked; a tensor taken out of the
checkpoint, which the JAX converter fills at random and the port's refuses,
naming it; fetch without ``--src`` and without huggingface_hub; and
``--device cuda`` without a card."""

import builtins
import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from audioeditingcode_tpu_torch.cli import validate_real_weights as tv
from audioeditingcode_tpu_torch.models import hf_checkpoint
from audioeditingcode_tpu_torch.utils.audio_io import write_wav
from test_convert_integration import (
    _mel_checkpoint,
    make_clap_text_model_dir,
    make_roberta_tokenizer_dir,
)

REHEARSAL = ["--num_diffusion_steps", "6", "--tstart", "4", "--target_prompt", "a trumpet",
             "--allow_mel_fallback", "--methods", "ours,ddim,sdedit",
             "--banner", "SYNTHETIC WEIGHTS — plumbing rehearsal, not results"]


@pytest.fixture(scope="module")
def fake_ckpt(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("src"))
    _mel_checkpoint(src, "test/tiny-audioldm")
    make_clap_text_model_dir(os.path.join(src, "text_encoder"), projection_dim=32)
    make_roberta_tokenizer_dir(os.path.join(src, "tokenizer"))
    return src


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    sr = 16000
    t = np.arange(sr // 2, dtype=np.float32) / sr
    p = str(tmp_path_factory.mktemp("clip") / "clip.wav")
    write_wav(p, (0.4 * np.sin(2 * np.pi * 330 * t))[None], sr)
    return p


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def rehearsals(fake_ckpt, clip, tmp_path_factory):
    """The all-lanes rehearsal by each tool: {"port"|"jax": (rc, stdout,
    work dir)}."""
    from audioeditingcode_tpu.evals import features as jfeatures
    from tools import validate_real_weights as jv

    def offline(target):  # no CLAP checkpoint here: the JAX tower would ask the hub
        raise OSError(f"no CLAP checkpoint {target!r} on this machine")

    real_tower, jfeatures.FlaxClapExtractor = jfeatures.FlaxClapExtractor, offline
    out = {}
    try:
        for name, main, extra in (("port", tv.main, ["--device", "cpu"]),
                                  ("jax", jv.main, [])):
            work = str(tmp_path_factory.mktemp(f"rehearsal_{name}"))
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = main(["--model_id", "test/tiny-audioldm", "--src", fake_ckpt,
                           "--work_dir", work, "--audio", clip] + REHEARSAL + extra)
            out[name] = (rc, printed.getvalue(), work)
    finally:
        jfeatures.FlaxClapExtractor = real_tower
    return out


def test_full_chain_passes_offline(fake_ckpt, clip, tmp_path, capsys):
    rc, out = _run(tv.main, [
        "--model_id", "test/tiny-audioldm", "--src", fake_ckpt, "--device", "cpu",
        "--work_dir", str(tmp_path / "work"), "--audio", clip,
        "--num_diffusion_steps", "6", "--tstart", "4",
        "--target_prompt", "a trumpet", "--allow_mel_fallback"], capsys)
    assert rc == 0, out
    # fetch PASSes on --src; manifest SKIPs (no vendored manifest for the
    # tiny family); everything else PASSes, at the real 40 dB bar
    assert "fetch: PASS" in out and "manifest: SKIP" in out
    for step in ("convert", "selfcheck", "edit", "evals", "page"):
        assert f"{step}: PASS" in out, out
    work = tmp_path / "work"
    page = (work / "supp.html").read_text()
    assert "No results yet" not in page and "<audio" in page
    assert any((work / "eval_scores").glob("scores_*.csv"))
    assert (work / "weights" / "test__tiny-audioldm" / "unet.msgpack").exists()


def test_full_rehearsal_all_lanes(rehearsals):
    """One command, every step, all three lanes: scores, figures (--plots)
    and a comparison page under the SYNTHETIC banner."""
    rc, out, work = rehearsals["port"]
    assert rc == 0, out
    for step in ("convert", "selfcheck", "edit", "evals", "page"):
        assert f"{step}: PASS" in out, out
    assert "ours:" in out and "ddim:" in out and "sdedit:" in out
    with open(os.path.join(work, "supp.html")) as f:
        page = f.read()
    assert "SYNTHETIC WEIGHTS" in page and 'class="banner"' in page
    assert "Method comparison" in page
    for lane in ("ours", "sdedit", "ddim"):
        assert f"<th>{lane}</th>" in page
    assert page.count("<audio") >= 4 and "No results yet" not in page
    srcs = re.findall(r'<audio controls preload="none" src="([^"]+)"', page)
    assert srcs and all(s.startswith("audio/") for s in srcs)
    assert all(os.path.isfile(os.path.join(work, s)) for s in srcs)
    scores = [f for f in os.listdir(os.path.join(work, "eval_scores"))
              if re.fullmatch(r"scores_.*\.csv", f)]
    assert sorted(scores) == ["scores_ddim.csv", "scores_ours.csv", "scores_sdedit.csv"]
    figures = [f for _, _, fs in os.walk(os.path.join(work, "eval_scores"))
               for f in fs if f.endswith(".png")]
    assert figures, f"--plots produced no figures: {out}"


def _masked(out: str, work: str, src: str) -> list:
    lines = [ln for ln in out.splitlines() if re.match(r"\[\d+/\d+\] |\[validate\] ", ln)]
    masked = []
    for ln in lines:
        ln = ln.replace(work, "<work>").replace(src, "<src>")
        ln = re.sub(r" \(\d+s\): ", " (Ns): ", ln)
        ln = re.sub(r"_\d{9,}\.wav", "_<time>.wav", ln)
        masked.append(ln)
    return masked


def test_step_lines_equal_the_jax_tool(rehearsals, fake_ckpt):
    """The same steps, statuses and messages as the JAX tool's on the same
    checkpoint and arguments, the seconds, paths and timestamps masked."""
    (prc, pout, pwork), (jrc, jout, jwork) = rehearsals["port"], rehearsals["jax"]
    assert prc == jrc == 0, (pout, jout)
    port, jax_lines = _masked(pout, pwork, fake_ckpt), _masked(jout, jwork, fake_ckpt)
    assert len(port) == 8 and port[-1].startswith("[validate]")
    assert port == jax_lines
    for lane in ("results", "results_ddim", "results_sdedit", "eval_scores", "audio",
                 "weights"):
        assert os.path.isdir(os.path.join(pwork, lane)), lane
        assert os.path.isdir(os.path.join(jwork, lane)), lane


def test_unknown_method_fails_loudly(tmp_path):
    with pytest.raises(SystemExit, match="unknown methods"):
        tv.main(["--model_id", "x", "--work_dir", str(tmp_path), "--methods", "ours,bogus"])


def test_selfcheck_gate_fails_on_low_snr(fake_ckpt, clip, tmp_path, capsys):
    """A collapsed reconstruction SNR fails the chain, with exit code 1."""
    rc, out = _run(tv.main, [
        "--model_id", "test/tiny-audioldm", "--src", fake_ckpt, "--device", "cpu",
        "--work_dir", str(tmp_path / "work2"), "--audio", clip,
        "--num_diffusion_steps", "6", "--tstart", "4",
        "--steps", "convert,selfcheck", "--min_snr_db", "100000"], capsys)
    assert rc == 1
    assert "selfcheck: FAIL" in out and "SNR" in out


def test_step_subset_and_unknown_step():
    with pytest.raises(SystemExit):
        tv.main(["--model_id", "x", "--work_dir", "/tmp/x", "--steps", "bogus"])
    args = tv.build_parser().parse_args(["--model_id", "x", "--work_dir", "/tmp/x"])
    assert args.num_diffusion_steps == 50 and args.min_snr_db == 40.0
    assert args.device == "cuda" and args.device_num == 0
    assert tv.STEPS == ["fetch", "manifest", "convert", "selfcheck", "edit", "evals", "page"]
    assert tv.METHODS == ["ours", "ddim", "sdedit"]


def test_checkpoint_steps_without_fetch_need_src(tmp_path):
    with pytest.raises(SystemExit, match="--src"):
        tv.main(["--model_id", "cvssp/audioldm2-music",
                 "--work_dir", str(tmp_path), "--steps", "manifest,convert"])


def test_convert_fails_on_a_removed_tensor_the_jax_tool_fills(fake_ckpt, tmp_path, capsys):
    """One UNet tensor taken out: the JAX converter keeps its random init
    and passes; the port's strict converter fails the step and names it."""
    from tools import validate_real_weights as jv

    src = str(tmp_path / "src")
    shutil.copytree(fake_ckpt, src)
    unet = os.path.join(src, "unet")
    (name,) = [f for f in os.listdir(unet) if f.endswith(".safetensors")]
    sd = hf_checkpoint.read_safetensors(os.path.join(unet, name))
    gone = sorted(k for k in sd if k.endswith("conv_out.bias"))[0]
    del sd[gone]
    hf_checkpoint.write_safetensors(sd, os.path.join(unet, name))
    argv = ["--model_id", "test/tiny-audioldm", "--src", src, "--steps", "fetch,convert"]
    rc, out = _run(jv.main, argv + ["--work_dir", str(tmp_path / "jax")], capsys)
    assert rc == 0 and "convert: PASS" in out, out
    rc, out = _run(tv.main, argv + ["--work_dir", str(tmp_path / "port"), "--device", "cpu"],
                   capsys)
    assert rc == 1 and "convert: FAIL" in out and "conv_out.bias" in out, out
    assert "[validate]" not in out


def test_fetch_without_src_or_hub_fails_and_names_it(tmp_path, capsys, monkeypatch):
    real_import = builtins.__import__

    def no_hub(name, *a, **kw):
        if name.split(".")[0] == "huggingface_hub":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_hub)
    rc, out = _run(tv.main, ["--model_id", "cvssp/audioldm2-music",
                             "--work_dir", str(tmp_path), "--steps", "fetch,manifest"], capsys)
    assert rc == 1
    assert "[1/2] fetch: FAIL" in out and "huggingface_hub" in out and "--src" in out
    assert "manifest" not in out


def test_manifest_step_reads_headers_and_counts(tmp_path, capsys):
    """The manifest step on a tree of safetensors headers with exactly the
    vendored manifest's keys and shapes (and no data) passes and counts
    them; one shape changed fails naming it."""
    model = "cvssp/audioldm2-music"
    mdir = os.path.join(tv.MANIFEST_DIR, model.replace("/", "__"))
    src = tmp_path / "src"
    total = 0
    for fname in sorted(os.listdir(mdir)):
        want = tv.read_manifest(os.path.join(mdir, fname))
        total += len(want)
        d = src / fname[:-4]
        d.mkdir(parents=True)
        sd = {k: torch.zeros(1).expand(s) if s else torch.zeros(())
              for k, s in want.items()}
        _write_header_only(sd, str(d / "model.safetensors"))
    rc, out = _run(tv.main, ["--model_id", model, "--src", str(src), "--device", "cpu",
                             "--work_dir", str(tmp_path / "w"), "--steps", "manifest"], capsys)
    assert rc == 0, out
    assert f"manifest: PASS (0s): {total} tensors match the vendored manifests" in out
    first = sorted(os.listdir(mdir))[0][:-4]
    path = str(src / first / "model.safetensors")
    shapes = hf_checkpoint.read_shapes(str(src / first))
    key = next(iter(shapes))
    _write_header_only({**{k: torch.zeros(1).expand(s) for k, s in shapes.items()},
                        key: torch.zeros(1).expand((7,))}, path)
    rc, out = _run(tv.main, ["--model_id", model, "--src", str(src), "--device", "cpu",
                             "--work_dir", str(tmp_path / "w"), "--steps", "manifest"], capsys)
    assert rc == 1 and "manifest: FAIL" in out and "shape-mismatch" in out and key in out


def _write_header_only(sd: dict, path: str) -> None:
    """A safetensors file whose header gives each tensor's shape and whose
    data is absent: the manifest step reads no more than the header."""
    import json
    import struct

    header = {k: {"dtype": "F32", "shape": list(v.shape), "data_offsets": [0, 0]}
              for k, v in sd.items()}
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)


def test_edits_on_a_missing_card_fail_the_step(fake_ckpt, clip, tmp_path, capsys, monkeypatch):
    """--device cuda without a card: the selfcheck step fails, never a
    silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(tv.main, [
        "--model_id", "test/tiny-audioldm", "--src", fake_ckpt,
        "--work_dir", str(tmp_path / "w"), "--audio", clip,
        "--num_diffusion_steps", "6", "--tstart", "4", "--steps", "convert,selfcheck"], capsys)
    assert rc == 1
    assert "[1/2] convert: PASS" in out and "[2/2] selfcheck: FAIL" in out and "CUDA" in out


def test_evals_without_matplotlib_fail_and_name_it(fake_ckpt, clip, tmp_path, capsys,
                                                   monkeypatch):
    """The evals step keeps --plots: where matplotlib is missing (the
    card's machine) it fails and names it, after the scores."""
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    rc, out = _run(tv.main, [
        "--model_id", "test/tiny-audioldm", "--src", fake_ckpt, "--device", "cpu",
        "--work_dir", str(tmp_path / "w"), "--audio", clip, "--allow_mel_fallback",
        "--num_diffusion_steps", "6", "--tstart", "4", "--steps", "convert,selfcheck,evals"],
        capsys)
    assert rc == 1
    assert "[3/3] evals: FAIL" in out and "matplotlib" in out, out
    assert (tmp_path / "w" / "eval_scores" / "scores_ours.csv").exists()
