"""The SDEdit baseline of the port against the JAX package on the CPU: the
Brownian-path noise (bit-equal: both are the same numpy code), the DDIM
loop on test/tiny-audioldm and the cosine-solver loop on
test/tiny-stable-audio with the JAX loops' own draws passed in, and the
port's SDEdit CLI on both tiny models.

Tolerance of the loops: 1e-3 relative (max abs error over max abs value).
They are eta-1 stochastic chains: each step adds fresh variance noise
scaled by the step's std, and the tiny AudioLDM's DDIM chain lifts each
step's float32 difference about 2.5x a step, the bound ROADMAP Queue C
records for the PC applications (tests/test_torch_pc_cli.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audioeditingcode_tpu.editing import sdedit as jsd
from audioeditingcode_tpu.schedulers import brownian as jbr
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.cli import sdedit as tcli
from audioeditingcode_tpu_torch.editing import sdedit as tsd
from audioeditingcode_tpu_torch.schedulers import brownian as tbr
from test_torch_helpers import (
    jax_tiny_pipeline,
    jax_tiny_stable_audio,
    port_tiny_pipeline,
    port_tiny_stable_audio,
    rel_err,
    to_np,
    write_stereo_wav,
    write_test_wav,
)

STEPS = 8
TOL = 1e-3


@pytest.mark.parametrize("seed,sigmas,shape", [
    (0, [500.0, 80.0, 3.0, 0.3, 0.0], (1, 4, 16)),
    (7, list(np.geomspace(500.0, 0.03, 21)) + [0.0], (1, 64, 8)),
    (123456789, [1.0, 0.5], (3,)),
    (2, [2.0, 2.0, 1.0], (2, 2)),  # a zero-width interval gets zero noise
])
def test_brownian_noise_is_bit_equal(seed, sigmas, shape):
    want = jbr.brownian_noise_for_sigmas(seed, np.float32(sigmas), shape)
    got = tbr.brownian_noise_for_sigmas(seed, np.float32(sigmas), shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    path_j, path_t = jbr.BrownianPath(seed, shape, 0.0, 3.0), tbr.BrownianPath(seed, shape, 0.0, 3.0)
    for t in (0.0, 0.7, 2.999, 3.0):
        np.testing.assert_array_equal(path_t(t), path_j(t))


def _jax_draws(w0_shape, runs, seed):
    """What the JAX loops draw inside: the start noise, then the per-step
    variance noise, from jax.random.split of the key."""
    k_noise, k_lat = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.normal(k_noise, w0_shape, dtype=jnp.float32)),
            np.array(jax.random.normal(k_lat, (runs,) + tuple(w0_shape), dtype=jnp.float32)))


@pytest.fixture(scope="module")
def audioldm(tmp_path_factory):
    wav = write_test_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"), seconds=0.5)
    jpipe = jax_tiny_pipeline(STEPS)
    return wav, jpipe, port_tiny_pipeline(STEPS, jpipe)


@pytest.mark.parametrize("skip,cfg_tar", [(2, 12.0), (5, 3.0)])
def test_sdedit_loop_matches_jax(audioldm, skip, cfg_tar):
    wav, jpipe, pipe = audioldm
    x0, _, _ = jio.load_audio(wav, jpipe.mel_config)
    jw0 = jpipe.vae_encode(jnp.asarray(x0))
    w0 = pipe.vae_encode(torch.from_numpy(x0))
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jsd.sdedit_loop(
        jpipe.sched, jpipe.make_eps_pair(jpipe.encode_text([""], negative=True),
                                         jpipe.encode_text(["a trumpet"])),
        jw0, rng, skip=skip, cfg_tar=cfg_tar))
    noise, latents = _jax_draws(w0.shape, STEPS - skip, 11)
    got = to_np(tsd.sdedit_loop(
        pipe.sched, pipe.make_eps_pair(pipe.encode_text([""], negative=True),
                                       pipe.encode_text(["a trumpet"])),
        w0, torch.from_numpy(noise), torch.from_numpy(latents), skip=skip, cfg_tar=cfg_tar))
    assert rel_err(got, want) < TOL


@pytest.fixture(scope="module")
def stable_audio(tmp_path_factory):
    wav = write_stereo_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"))
    jpipe = jax_tiny_stable_audio(STEPS)
    return wav, jpipe, port_tiny_stable_audio(STEPS, jpipe)


@pytest.mark.parametrize("noise_sampler", ["brownian", "iid"])
def test_sdedit_loop_cosine_matches_jax(stable_audio, noise_sampler):
    """Both packages on the same latent (the clip itself stands in for the
    VAE latent's shape), the JAX start draw, and the per-step noise of the
    JAX CLI's --noise_sampler: the Brownian increments or the loop's own
    i.i.d. draws."""
    _, jpipe, pipe = stable_audio
    skip = 3
    w0 = np.random.default_rng(4).standard_normal((1, 4, 16)).astype(np.float32)
    noise, latents = _jax_draws(w0.shape, STEPS - skip, 5)
    zs = None
    if noise_sampler == "brownian":
        zs = tbr.brownian_noise_for_sigmas(5, pipe.sched.sched.sigmas_host[skip:], w0.shape)
        latents = zs
    want = np.asarray(jsd.sdedit_loop_cosine(
        jpipe.sched, jpipe.make_eps_pair(jpipe.encode_text([""], negative=True),
                                         jpipe.encode_text(["a cello"])),
        jnp.asarray(w0), jax.random.PRNGKey(5), skip=skip, cfg_tar=7.0,
        noises=None if zs is None else jnp.asarray(zs)))
    got = to_np(tsd.sdedit_loop_cosine(
        pipe.sched, pipe.make_eps_pair(pipe.encode_text([""], negative=True),
                                       pipe.encode_text(["a cello"])),
        torch.from_numpy(w0), torch.from_numpy(noise), torch.from_numpy(latents), skip=skip,
        cfg_tar=7.0))
    assert rel_err(got, want) < TOL


def test_sdedit_loops_check_noise_shapes(audioldm):
    _, _, pipe = audioldm
    w0 = torch.zeros(1, 4, 8, 16)
    pair = pipe.make_eps_pair(pipe.encode_text([""], negative=True), None)
    with pytest.raises(ValueError, match="per-step noise"):
        tsd.sdedit_loop(pipe.sched, pair, w0, torch.zeros_like(w0),
                        torch.zeros((STEPS,) + tuple(w0.shape)), skip=2, cfg_tar=3.0)
    with pytest.raises(ValueError, match="start noise"):
        tsd.sdedit_loop(pipe.sched, pair, w0, torch.zeros(1, 4, 8, 8),
                        torch.zeros((6,) + tuple(w0.shape)), skip=2, cfg_tar=3.0)


@pytest.mark.parametrize("model,extra", [
    ("test/tiny-audioldm", []),
    ("test/tiny-audioldm", ["--dtype", "bfloat16"]),
    ("test/tiny-audioldm2", []),
    ("test/tiny-stable-audio", []),
    ("test/tiny-stable-audio", ["--noise_sampler", "iid"]),
    ("test/tiny-stable-audio", ["--dtype", "bfloat16"]),
])
def test_sdedit_cli_on_cpu(tmp_path, model, extra):
    """The JAX CLI's results layout and file name, a finite wav at the
    model's rate that differs from orig.wav, and the run record."""
    stereo = model == "test/tiny-stable-audio"
    wav = (write_stereo_wav(str(tmp_path / "clip.wav")) if stereo
           else write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3))
    out = tcli.main(["--device", "cpu", "--model_id", model, "--init_aud", wav,
                     "--num_diffusion_steps", "6", "--tstart", "4", "--seed", "3",
                     "--target_prompt", "a cello", "--results_path", str(tmp_path / "r")]
                    + extra)
    d = os.path.dirname(out)
    assert d == os.path.join(str(tmp_path / "r"), model.split("/")[1], "clip",
                             "pmt_a_cello__neg__")
    assert os.path.basename(out) == "s3_skip2_cfg12.wav"
    want = ["s3_skip2_cfg12.wav", "orig.wav", "run_args.json"]
    assert sorted(os.listdir(d)) == sorted(want + ([] if stereo else ["s3_skip2_cfg12.png"]))
    (sr, audio), (_, orig) = wavfile.read(out), wavfile.read(os.path.join(d, "orig.wav"))
    assert sr == (4000 if stereo else 16000)
    if stereo:  # the edit is cropped to the tiny model's 64 samples, orig.wav is the clip
        assert audio.shape == (64, 2) and orig.shape == (4000, 2)
        assert np.any(audio != orig[:64])
    else:
        assert audio.ndim == 1 and audio.shape == orig.shape and np.any(audio != orig)
    with open(os.path.join(d, "run_args.json")) as f:
        rec = json.load(f)
    assert rec["unet_steps"] == 4 and rec["sdedit_seconds"] > 0 and rec["device"] == "cpu"
    assert rec["seed"] == 3 and rec["eta"] == 1.0
    assert (rec["noise_seconds"] > 0) == (stereo and "iid" not in extra)


def test_sdedit_cli_seeds_reproduce(tmp_path):
    """One seed gives one wav; another seed another."""
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    outs = [wavfile.read(tcli.main(["--device", "cpu", "--model_id", "test/tiny-audioldm",
                                    "--init_aud", wav, "--num_diffusion_steps", "6",
                                    "--tstart", "4", "--seed", str(seed),
                                    "--target_prompt", "a cello",
                                    "--results_path", str(tmp_path / f"r{i}")]))[1]
            for i, seed in enumerate((1, 1, 2))]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.any(outs[0] != outs[2])


def test_sdedit_cli_rejects_unported(tmp_path):
    """--weights_dir is ported: a directory without converted weights
    raises as the JAX registry does."""
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    with pytest.raises(FileNotFoundError, match="missing converted weights"):
        tcli.main(["--device", "cpu", "--model_id", "test/tiny-audioldm", "--init_aud", wav,
                   "--weights_dir", str(tmp_path)])
