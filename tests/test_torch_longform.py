"""Long-form editing of the port against the JAX package on the CPU: the
window geometry and crossfade of ``editing/longform.py`` (numpy in both
packages: exactly equal), the window fold of ``editing/batched.py`` (the
N-window edit equals N single-window edits, and a fold that sums the
windows' guidance fails that check), and ``cli/run_long.py`` against the
JAX CLI on test/tiny-audioldm and test/tiny-stable-audio.

Tolerances: the fold 1e-4 relative (max abs error over max abs value: the
same float32 ops on 2N rows or on 2, which the CPU's convolutions and
matmuls may sum in other orders; the tiny DiT reads 1.7e-5); the CLI wavs
within one int16 LSB beside 2e-4 relative, as tests/test_torch_weights_cli.py
holds the edit CLIs (the edit reuses its recorded noise maps, so no fresh
noise lifts the error); on Stable Audio the edited latents to 5e-3, the
bound tests/test_torch_stable_audio_e2e.py sets for an edit from each
package's own Oobleck encode of the clip (measured 1.8e-3 here). The
JAX CLI draws each window's inversion noise from its own key
(``jax.random.split(rng, n_windows)`` under ``jax.vmap``); the port CLI is
handed those draws."""

import os

import jax
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.cli import run_long as jrl
from audioeditingcode_tpu.editing import longform as jlf
from audioeditingcode_tpu_torch.cli import run_long as trl
from audioeditingcode_tpu_torch.editing import longform as tlf
from audioeditingcode_tpu_torch.editing.batched import edit_windows, make_window_denoiser
from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors
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
FOLD_TOL = 1e-4
WAV_TOL = 2e-4
SA_LATENT_TOL = 5e-3


@pytest.mark.parametrize("n,win,hop", [(10, 10, 5), (4, 10, 5), (23, 10, 4), (100, 24, 20),
                                       (2560, 1024, 920), (661500, 441000, 396900)])
def test_window_starts_match_jax(n, win, hop):
    starts = tlf.window_starts(n, win, hop)
    assert starts == jlf.window_starts(n, win, hop)
    assert starts[0] == 0 and starts[-1] + win >= n
    assert all(b - a <= hop for a, b in zip(starts, starts[1:]))


@pytest.mark.parametrize("T,win,hop", [(30, 8, 6), (5, 8, 4), (64, 16, 12), (16, 16, 8)])
def test_split_windows_matches_jax(T, win, hop):
    mel = np.random.default_rng(T).standard_normal((1, 1, T, 6)).astype(np.float32)
    wins, starts = tlf.split_windows(mel, win, hop)
    jwins, jstarts = jlf.split_windows(mel, win, hop)
    assert starts == jstarts
    np.testing.assert_array_equal(wins, jwins)


@pytest.mark.parametrize("starts,Tw,total", [([0, 920, 1536], 1024, 2560), ([0, 6], 10, 16),
                                             ([0, 3, 6, 9], 5, 14), ([0], 8, 6)])
def test_overlap_add_matches_jax_and_weights_sum_to_one(starts, Tw, total):
    wavs = np.random.default_rng(Tw).standard_normal((len(starts), 2, Tw)).astype(np.float32)
    out = tlf.overlap_add(wavs, starts, total)
    np.testing.assert_array_equal(out, jlf.overlap_add(wavs, starts, total))
    # windows cut from one signal stitch back to it: the weights sum to 1
    sig = np.random.default_rng(1).standard_normal((2, max(total, Tw))).astype(np.float32)
    cut = np.stack([np.pad(sig, ((0, 0), (0, Tw)))[:, s: s + Tw] for s in starts])
    np.testing.assert_allclose(tlf.overlap_add(cut, starts, total), sig[:, :total],
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the window fold
def _fold_case(model_id):
    """A seeded tiny pipeline, 3 windows' latents and their noise."""
    pipe = load_model(model_id, STEPS, device="cpu", seed=2)
    g = torch.Generator().manual_seed(5)
    if model_id == "test/tiny-stable-audio":
        shape = (3, pipe.dit.config.in_channels, pipe.sample_size)
        pipe.setup_duration(0.0, 0.01)
    else:
        shape = (3, pipe.unet.config.in_channels, 8, 4)
    return pipe, torch.randn(shape, generator=g), torch.randn((STEPS,) + shape, generator=g)


def _denoisers(pipe, shape, make):
    empty = pipe.encode_text([""], negative=True)
    cfg_src, _ = build_cfg_tensors((1,) + shape[1:], ["a sine tone"], [3.0])
    cfg_tar, _ = build_cfg_tensors((1,) + shape[1:], ["a trumpet"], [12.0])
    return (make(pipe.make_eps_pair(empty, pipe.encode_text(["a sine tone"])), cfg_src),
            make(pipe.make_eps_pair(empty, pipe.encode_text(["a trumpet"])), cfg_tar))


def _fold_error(model_id, make) -> float:
    """The folded 3-window edit against each window's single edit."""
    from audioeditingcode_tpu_torch.editing.invert import make_cfg_denoiser

    pipe, w0, noise = _fold_case(model_id)
    tstart = 4
    folded = edit_windows(pipe.sched, *_denoisers(pipe, tuple(w0.shape), make), w0, noise,
                          tstart)
    single = torch.cat([edit_windows(pipe.sched,
                                     *_denoisers(pipe, tuple(w0.shape), make_cfg_denoiser),
                                     w0[i: i + 1], noise[:, i: i + 1], tstart)
                        for i in range(w0.shape[0])])
    assert folded.shape == w0.shape and torch.isfinite(folded).all()
    return rel_err(folded.numpy(), single.numpy())


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
def test_folded_edit_equals_single_window_edits(model_id):
    assert _fold_error(model_id, make_window_denoiser) < FOLD_TOL


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
def test_a_fold_that_sums_the_windows_fails(model_id):
    """The pipelines' own CFG denoiser reads the leading axis as prompts and
    sums their guidance: given the window batch, it runs with no error and
    mixes the windows."""
    from audioeditingcode_tpu_torch.editing.invert import make_cfg_denoiser

    assert _fold_error(model_id, make_cfg_denoiser) > 100 * FOLD_TOL


def test_window_denoiser_rejects_several_prompts():
    pipe, w0, _ = _fold_case("test/tiny-audioldm")
    pair = pipe.make_eps_pair(pipe.encode_text([""], negative=True),
                              pipe.encode_text(["a", "b"]))
    with pytest.raises(ValueError, match="one prompt per window"):
        make_window_denoiser(pair, torch.ones((2,) + tuple(w0.shape[1:])))
    den = make_window_denoiser(pair, torch.ones((1,) + tuple(w0.shape[1:])))
    with pytest.raises(ValueError, match="single prompt"):
        den(w0[:1], 0)


# ------------------------------------------------------------------ the CLI
def _inject_window_noise(monkeypatch, rng, steps):
    """Each window's inversion draw from its key of split(rng, n_windows)."""
    def noise(gen, S, w0):
        assert S == steps
        return jax_row_noise(rng, S, w0)

    monkeypatch.setattr(trl, "_inversion_noise", noise)


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, model_id):
    """3 mel windows over a 0.9 s clip (0.4 s chunks, 0.1 s overlap), or 4
    Stable Audio windows over 200 samples (64-sample chunks): the same
    results layout and the same stitched wav, max(T, win) * 160 samples
    long on the mel path and the clip's length on the waveform path."""
    from scipy.io import wavfile

    seed = 2
    sa = model_id == "test/tiny-stable-audio"
    if sa:
        wav = write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05)
        chunk = ["--chunk_seconds", "0.016", "--overlap_seconds", "0.004"]
    else:
        wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.9)
        chunk = ["--chunk_seconds", "0.4", "--overlap_seconds", "0.1"]
    load = bridged_loader(model_id, STEPS)
    rng = jax.random.PRNGKey(seed)
    if sa:
        rng, enc_rng = jax.random.split(rng)
        jpipe = jax_tiny_stable_audio(STEPS)

        def load_enc(*a, **kw):
            pipe = load(*a, **kw)
            real = type(pipe).vae_encode
            pipe.vae_encode = lambda x, noise=None: real(
                pipe, x, jax_vae_noise(jpipe, x.shape[0], enc_rng))
            return pipe

        monkeypatch.setattr(trl, "load_model", load_enc)
    else:
        monkeypatch.setattr(trl, "load_model", load)
    _inject_window_noise(monkeypatch, rng, STEPS)
    argv = ["--model_id", model_id, "--init_aud", wav, "--target_prompt", "a trumpet",
            "--source_prompt", "a sine tone", "--num_diffusion_steps", str(STEPS),
            "--tstart", "4", "--seed", str(seed)] + chunk
    latents = record_stable_audio_decodes(monkeypatch)
    j = jrl.main(argv + ["--results_path", str(tmp_path / "jax")])
    t = trl.main(argv + ["--device", "cpu", "--results_path", str(tmp_path / "port")])
    assert results_layout(t, tmp_path / "port") == results_layout(j, tmp_path / "jax")
    if sa:  # the edited latents (test_torch_helpers.record_stable_audio_decodes)
        assert len(latents["jax"]) == len(latents["port"]) == 1
        assert rel_err(latents["port"][0], latents["jax"][0]) < SA_LATENT_TOL
    else:
        wav_close(t, j, WAV_TOL)
    import json

    with open(os.path.join(os.path.dirname(t), "run_args.json")) as f:
        rec = json.load(f)
    n_win = 4 if sa else 3
    assert rec["n_windows"] == n_win and rec["unet_steps"] == STEPS + 4
    _, data = wavfile.read(t)
    assert data.shape[0] == (200 if sa else max(int(0.9 * 102.4), rec["win_frames"]) * 160)


@pytest.mark.parametrize("extra", [["--dp", "2"], ["--tp", "2"], ["--sp", "2"]])
def test_cli_rejects_parallel_flags(tmp_path, monkeypatch, extra):
    """--dp/--tp/--sp are ported (tests/test_torch_parallel_cli.py): on the
    card two ranks on a machine of one card (the count patched) raise before
    any rank starts, and --sp 2 on a mel family raises the JAX ValueError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    sp = extra[0] == "--sp"
    with pytest.raises(ValueError, match="requires a stable-audio" if sp else "CUDA device"):
        trl.main(["--device", "cpu" if sp else "cuda", "--model_id", "test/tiny-audioldm",
                  "--init_aud", wav, "--target_prompt", "a trumpet",
                  "--results_path", str(tmp_path)] + extra)
