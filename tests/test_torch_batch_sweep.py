"""Batch editing and the tstart x cfg sweep of the port against the JAX
package on the CPU: ``cli/run_batch.py`` (several clips folded into each
denoiser forward, Stable Audio's per-clip duration conditioning) and
``cli/sweep.py`` (one inversion, one reverse pass per grid point), each
against its JAX CLI on test/tiny-audioldm and test/tiny-stable-audio; each
sweep grid point against the port's own ``cli/run.py`` edit; the CLIs'
errors.

Tolerances: the mel CLI wavs within one int16 LSB beside 2e-4 relative (max
abs error over max abs value), as tests/test_torch_weights_cli.py holds the
edit CLIs; on Stable Audio the edited latents the CLIs decode
(test_torch_helpers.record_stable_audio_decodes) to 5e-3, the bound of
tests/test_torch_stable_audio_e2e.py for an edit from each package's own
Oobleck encode; a folded forward with per-clip durations against the
per-clip forwards 1e-5; a sweep grid point against ``cli/run.py`` on the same
weights, draws and device: one LSB (the same ops in the same order). The
JAX CLIs' draws (per clip from ``jax.random.split(rng, n_clips)`` under
``jax.vmap``; the sweep's inversion from a split of its key) are handed to
the port CLIs."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.cli import run_batch as jrb
from audioeditingcode_tpu.cli import sweep as jsw
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.cli import run_batch as trb
from audioeditingcode_tpu_torch.cli import sweep as tsw
from audioeditingcode_tpu_torch.models.registry import load_model
from test_torch_helpers import (
    bridged_loader,
    jax_row_noise,
    jax_tiny_stable_audio,
    jax_vae_noise,
    record_stable_audio_decodes,
    rel_err,
    results_layout,
    wav_close,
    write_stereo_wav,
    write_test_wav,
)

STEPS = 6
WAV_TOL = 2e-4
SA_LATENT_TOL = 5e-3
ROW_TOL = 1e-5
SA = "test/tiny-stable-audio"
MEL = "test/tiny-audioldm"


def _clips(d, model_id, lengths):
    os.makedirs(d, exist_ok=True)
    write = write_stereo_wav if model_id == SA else write_test_wav
    return [write(os.path.join(d, f"clip{i}.wav"), seconds=s) for i, s in enumerate(lengths)]


def _loader(monkeypatch, module, model_id, enc_rng=None):
    """The bridged pipeline; on Stable Audio its latent sample takes the JAX
    draw of ``enc_rng``."""
    load = bridged_loader(model_id, STEPS)
    if enc_rng is None:
        monkeypatch.setattr(module, "load_model", load)
        return
    jpipe = jax_tiny_stable_audio(STEPS)

    def load_enc(*a, **kw):
        pipe = load(*a, **kw)
        real = type(pipe).vae_encode
        pipe.vae_encode = lambda x, noise=None: real(
            pipe, x, jax_vae_noise(jpipe, 1 if x.dim() == 2 else x.shape[0], enc_rng))
        return pipe

    monkeypatch.setattr(module, "load_model", load_enc)


# ------------------------------------------------------------------ run_batch
@pytest.mark.parametrize("model_id,lengths", [(MEL, [0.2, 0.3, 0.25]), (SA, [0.012, 0.016])])
def test_run_batch_matches_jax_cli(tmp_path, monkeypatch, model_id, lengths):
    """Three mel clips of different lengths from a directory, or two Stable
    Audio clips (each with its own duration conditioning): each clip's
    results layout, its wav (mel) or the edited latents (Stable Audio), and
    each output cropped to its clip's length."""
    from scipy.io import wavfile

    seed = 3
    paths = _clips(str(tmp_path / "clips"), model_id, lengths)
    rng = jax.random.PRNGKey(seed)
    enc_rng = None
    if model_id == SA:
        rng, enc_rng = jax.random.split(rng)
    _loader(monkeypatch, trb, model_id, enc_rng)
    monkeypatch.setattr(trb, "_inversion_noise", lambda gen, S, w0: jax_row_noise(rng, S, w0))
    latents = record_stable_audio_decodes(monkeypatch)
    clips = [str(tmp_path / "clips")] if model_id == MEL else paths
    argv = ["--model_id", model_id, "--init_aud", *clips, "--target_prompt", "a trumpet",
            "--source_prompt", "a sine tone", "--num_diffusion_steps", str(STEPS),
            "--tstart", "4", "--seed", str(seed)]
    j = jrb.main(argv + ["--results_path", str(tmp_path / "jax")])
    t = trb.main(argv + ["--device", "cpu", "--results_path", str(tmp_path / "port")])
    assert len(t) == len(j) == len(lengths)
    for a, b, p, sec in zip(t, j, paths, lengths):
        assert results_layout(a, tmp_path / "port") == results_layout(b, tmp_path / "jax")
        sr, data = wavfile.read(a)
        if model_id == SA:
            assert data.shape == wavfile.read(p)[1].shape
        else:
            wav_close(a, b, WAV_TOL)
            assert data.shape[0] == int(sec * 102.4) * 160
        with open(os.path.join(os.path.dirname(a), "run_args.json")) as f:
            rec = json.load(f)
        assert rec["batched"] and rec["n_clips"] == len(lengths)
        assert rec["unet_steps"] == STEPS + 4
    if model_id == SA:
        assert len(latents["jax"]) == len(latents["port"]) == 1
        assert rel_err(latents["port"][0], latents["jax"][0]) < SA_LATENT_TOL


def test_per_clip_duration_rows_follow_the_cfg_fold():
    """Clips of different durations in one forward of 2N rows: each row's
    output equals its clip's forward alone, and the unconditional rows
    (an all-zero text mask) carry no duration embeds."""
    pipe = load_model(SA, STEPS, device="cpu", seed=4)
    durs = [0.008, 0.016, 0.012]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, pipe.dit.config.in_channels, pipe.sample_size), generator=g)
    pair = pipe.make_eps_pair(pipe.encode_text([""], negative=True), pipe.encode_text(["a cello"]))
    seen = []
    hook = pipe.dit.register_forward_pre_hook(lambda m, args: seen.append(args[2].clone()))
    pipe.setup_clip_durations(durs)
    rows = pipe._duration_embeds
    eps_u, eps_c = pair(x, x, 2)
    hook.remove()
    embeds = seen[0]  # (2N, text + 2, D): the N unconditional rows, then the N conditional
    assert embeds.shape[0] == 6
    assert torch.count_nonzero(embeds[:3]) == 0
    assert torch.equal(embeds[3:, -2:], rows.to(embeds.dtype))
    for i, d in enumerate(durs):
        pipe.setup_duration(0.0, d)
        assert torch.equal(pipe._duration_embeds, rows[i: i + 1])
        u, c = pair(x[i: i + 1], x[i: i + 1], 2)
        assert rel_err(eps_u[i: i + 1].numpy(), u.numpy()) < ROW_TOL
        assert rel_err(eps_c[i: i + 1].numpy(), c.numpy()) < ROW_TOL
    assert pipe._waveform_end == int(0.012 * pipe.sample_rate)
    pipe.setup_clip_durations(durs)
    assert pipe._waveform_end == int(0.016 * pipe.sample_rate)
    with pytest.raises(ValueError, match="rows for 3 clips"):
        pair(x[:2], x[:2], 2)


@pytest.mark.parametrize("case,error,match", [
    ("mixed", ValueError, "share a channel count"),
    ("collide", ValueError, "share the results basename"),
    ("missing", FileNotFoundError, "no such file"),
    ("empty", FileNotFoundError, "no .wav files"),
    ("dp", ValueError, "CUDA device"),
])
def test_run_batch_errors(tmp_path, monkeypatch, case, error, match):
    d = tmp_path / "c"
    d.mkdir()
    model_id, clips = MEL, [write_test_wav(str(d / "a.wav"), seconds=0.2)]
    extra = []
    if case == "mixed":
        model_id = SA
        clips = [write_test_wav(str(d / "mono.wav"), seconds=0.01, sr=4000),
                 write_stereo_wav(str(d / "stereo.wav"), seconds=0.01)]
    elif case == "collide":
        (tmp_path / "other").mkdir()
        clips.append(write_test_wav(str(tmp_path / "other" / "a.b.wav"), seconds=0.2))
    elif case == "missing":
        clips.append(str(d / "missing.wav"))
    elif case == "empty":
        clips = [str(tmp_path / "other_dir")]
        os.makedirs(clips[0])
    else:
        # --dp is ported (tests/test_torch_parallel_cli.py): on the card two
        # ranks on a machine of one card (the count patched) raise first
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        extra = ["--dp", "2", "--device", "cuda"]
    with pytest.raises(error, match=match):
        trb.main(["--device", "cpu", "--model_id", model_id, "--init_aud", *clips,
                  "--target_prompt", "a trumpet", "--num_diffusion_steps", "4",
                  "--results_path", str(tmp_path / "r")] + extra)


# ------------------------------------------------------------------ sweep
def _sweep_argv(wav, model_id, seed):
    return ["--model_id", model_id, "--init_aud", wav, "--target_prompt", "a trumpet",
            "--source_prompt", "a sine tone", "--num_diffusion_steps", str(STEPS),
            "--tstarts", "4", "2", "--cfg_tars", "8", "12", "--seed", str(seed)]


@pytest.mark.parametrize("model_id", [MEL, SA])
def test_sweep_matches_jax_cli(tmp_path, monkeypatch, model_id):
    """A 2 x 2 grid off one inversion: the same results layout, and each
    grid point's wav (mel) or edited latent (Stable Audio)."""
    seed = 5
    wav = (write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05) if model_id == SA
           else write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3))
    rng = jax.random.PRNGKey(seed)
    enc_rng = None
    if model_id == SA:
        rng, enc_rng = jax.random.split(rng)
    _loader(monkeypatch, tsw, model_id, enc_rng)
    _, r_inv = jax.random.split(rng)
    real = tsw.inversion_forward_process

    def inv(sched, den, w0, gen, **kw):
        z = np.asarray(jax.random.normal(r_inv, (STEPS,) + tuple(w0.shape)))
        return real(sched, den, w0, torch.from_numpy(z), **kw)

    monkeypatch.setattr(tsw, "inversion_forward_process", inv)
    latents = record_stable_audio_decodes(monkeypatch)
    argv = _sweep_argv(wav, model_id, seed)
    j = jsw.main(argv + ["--results_path", str(tmp_path / "jax")])
    t = tsw.main(argv + ["--device", "cpu", "--results_path", str(tmp_path / "port")])
    assert len(t) == len(j) == 4
    assert results_layout(t[0], tmp_path / "port") == results_layout(j[0], tmp_path / "jax")
    for a, b in zip(t, j):
        assert os.path.basename(a).rsplit("_", 1)[0] == os.path.basename(b).rsplit("_", 1)[0]
        if model_id == MEL:
            wav_close(a, b, WAV_TOL)
    if model_id == SA:
        assert len(latents["jax"]) == len(latents["port"]) == 4
        for got, want in zip(latents["port"], latents["jax"]):
            assert rel_err(got, want) < SA_LATENT_TOL
    with open(os.path.join(os.path.dirname(t[0]), "run_args.json")) as f:
        rec = json.load(f)
    assert rec["unet_steps"] == STEPS + 2 * (4 + 2) and rec["n_edits"] == 4


@pytest.mark.parametrize("model_id", [MEL, SA])
def test_sweep_points_equal_the_edit_cli(tmp_path, model_id):
    """Each grid point is ``cli/run.py --mode ours`` at its tstart and
    cfg_tar with the same seed: the same weights and draws, so the same wav."""
    seed = 7
    wav = (write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05) if model_id == SA
           else write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3))
    outs = tsw.main(_sweep_argv(wav, model_id, seed)
                    + ["--device", "cpu", "--results_path", str(tmp_path / "sweep")])
    for out, (t, cfg) in zip(outs, [(4, 8), (4, 12), (2, 8), (2, 12)]):
        edit = trun.main(["--device", "cpu", "--model_id", model_id, "--init_aud", wav,
                          "--target_prompt", "a trumpet", "--source_prompt", "a sine tone",
                          "--num_diffusion_steps", str(STEPS), "--tstart", str(t),
                          "--cfg_tar", str(cfg), "--seed", str(seed),
                          "--results_path", str(tmp_path / f"run_{t}_{cfg}")])
        assert wav_close(out, edit, 0.0) == 0.0


def test_sweep_rejects_parallel_flags(tmp_path, monkeypatch):
    """--dp/--tp are ported (the sweep runs them as cli/run.py does): two
    ranks on a machine of one card (the count patched) raise before any
    rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    with pytest.raises(ValueError, match="CUDA device"):
        tsw.main(["--device", "cuda", "--model_id", MEL, "--init_aud", wav,
                  "--target_prompt", "a trumpet", "--dp", "2", "--results_path",
                  str(tmp_path)])


@pytest.mark.parametrize("cli", ["generate", "run_long", "run_batch", "sweep"])
def test_new_clis_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch, cli):
    """No --device: the CLI asks for the card, and a machine without one
    is an error before any model loads, never a silent CPU run."""
    import importlib

    module = importlib.import_module(f"audioeditingcode_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(module, "load_model", lambda *a, **k: pytest.fail("model loaded"))
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.2)
    argv = (["-t", "a dog", "--model_id", MEL] if cli == "generate" else
            ["--model_id", MEL, "--init_aud", wav, "--target_prompt", "a dog"])
    assert module.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
