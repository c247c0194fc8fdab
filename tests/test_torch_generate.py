"""The port's generation primitives and generation CLI against the JAX
package on the CPU: ``editing/generate.py`` function by function,
``cli/generate.py`` on test/tiny-audioldm and test/tiny-stable-audio, the
kept region of inpainting, and the CLI's errors.

Tolerances: each function with a stub denoiser (the schedule and solver
math alone, float32 elementwise) 1e-5 relative (max abs error over max abs
value). Through the tiny models the functions and the CLIs are eta-1 chains,
whose fresh per-step noise lifts each step's float32 difference (ROADMAP
Queue C: about 2.5x a step on the tiny AudioLDM), so they are held at 1e-3
relative, and the CLI wavs (int16) within one LSB beside it. The JAX
functions draw their noise from ``jax.random.split`` of a key; the port's
take it as arguments, so they are handed the JAX draws from the same
keys."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.cli import generate as jcli
from audioeditingcode_tpu.editing import generate as jgen
from audioeditingcode_tpu.schedulers import ddim as jd
from audioeditingcode_tpu_torch.cli import generate as tcli
from audioeditingcode_tpu_torch.editing import generate as tgen
from audioeditingcode_tpu_torch.models.registry import load_model
from audioeditingcode_tpu_torch.schedulers import ddim as td
from test_torch_helpers import (
    bridged_loader,
    jax_tiny_stable_audio,
    jax_vae_noise,
    port_tiny_stable_audio,
    record_stable_audio_decodes,
    rel_err,
    results_layout,
    to_np,
    wav_close,
    write_stereo_wav,
    write_test_wav,
)

STEPS = 8
STUB_TOL = 1e-5
CHAIN_TOL = 1e-3
SHAPE = (2, 4, 8, 6)


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), dtype=jnp.float32)))


def _stub_denoisers():
    """The same deterministic stand-in for a CFG denoiser in both packages."""
    return ((lambda xt, k: 0.3 * jnp.tanh(xt) + 0.01 * k),
            (lambda xt, k: 0.3 * torch.tanh(xt) + 0.01 * k))


def _stub_pairs():
    return ((lambda xu, xc, k: (0.3 * jnp.tanh(xu), 0.2 * jnp.sin(xc) + 0.05)),
            (lambda xu, xc, k: (0.3 * torch.tanh(xu), 0.2 * torch.sin(xc) + 0.05)))


@pytest.fixture(scope="module")
def scheds():
    return jd.make_schedule(jd.DDIMConfig(), STEPS), td.make_schedule(td.DDIMConfig(), STEPS)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_text_to_audio_matches_jax(scheds, eta):
    """generation_loop through text_to_audio_latents: the start latent and
    the per-step noise are the JAX loop's draws."""
    js, ts = scheds
    jden, tden = _stub_denoisers()
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jgen.text_to_audio_latents(js, jden, SHAPE, rng, eta=eta))
    r_init, r_steps = jax.random.split(rng)
    got = tgen.text_to_audio_latents(ts, tden, _normal(r_init, SHAPE),
                                     _normal(r_steps, (STEPS,) + SHAPE), eta=eta)
    assert rel_err(to_np(got), want) < STUB_TOL


@pytest.mark.parametrize("strength", [0.5, 0.75, 1.0])
def test_style_transfer_matches_jax(scheds, strength):
    js, ts = scheds
    jden, tden = _stub_denoisers()
    w0 = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jgen.style_transfer_latents(js, jden, jnp.asarray(w0), rng, strength))
    r_noise, r_steps = jax.random.split(rng)
    skip = tgen.transfer_skip(ts, strength)
    got = tgen.style_transfer_latents(
        ts, tden, torch.from_numpy(w0), _normal(r_noise, SHAPE),
        _normal(jax.random.split(r_steps)[1], (STEPS - skip,) + SHAPE), strength)
    assert rel_err(to_np(got), want) < STUB_TOL


def test_style_transfer_at_zero_strength_gives_back_the_input(scheds):
    _, ts = scheds
    w0 = torch.randn(SHAPE)
    assert tgen.transfer_skip(ts, 0.0) == STEPS
    got = tgen.style_transfer_latents(ts, _stub_denoisers()[1], w0, None,
                                      torch.zeros((0,) + SHAPE), 0.0)
    assert got is w0


def _mask(shape, axis, lo, hi):
    m = np.zeros(shape, np.float32)
    idx = [slice(None)] * len(shape)
    idx[axis] = slice(lo, hi)
    m[tuple(idx)] = 1.0
    return m


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_inpaint_matches_jax(scheds, eta):
    js, ts = scheds
    jden, tden = _stub_denoisers()
    w0 = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    mask = _mask(SHAPE, 2, 2, 5)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jgen.inpaint_latents(js, jden, jnp.asarray(w0), jnp.asarray(mask), rng,
                                           eta=eta))
    r_init, r_keep, r_steps = jax.random.split(rng, 3)
    got = tgen.inpaint_latents(ts, tden, torch.from_numpy(w0), torch.from_numpy(mask),
                               _normal(r_init, SHAPE), _normal(r_keep, (STEPS,) + SHAPE),
                               _normal(r_steps, (STEPS,) + SHAPE), eta=eta)
    assert rel_err(to_np(got), want) < STUB_TOL
    assert torch.equal(got[:, :, :2], torch.from_numpy(w0)[:, :, :2])


@pytest.fixture(scope="module")
def stable_audio():
    jpipe = jax_tiny_stable_audio(STEPS)
    return jpipe, port_tiny_stable_audio(STEPS, jpipe)


@pytest.mark.parametrize("brownian", [False, True])
def test_inpaint_cosine_matches_jax(stable_audio, brownian):
    """The cosine-solver inpainting with i.i.d. or Brownian per-step noise
    (the Brownian increments are the same numpy code in both packages)."""
    from audioeditingcode_tpu_torch.schedulers.brownian import brownian_noise_for_sigmas

    jpipe, pipe = stable_audio
    jpair, tpair = _stub_pairs()
    shape = (1, 4, 16)
    w0 = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    mask = _mask(shape, 2, 4, 11)
    rng = jax.random.PRNGKey(9)
    r_init, r_keep, r_steps = jax.random.split(rng, 3)
    zs = (brownian_noise_for_sigmas(9, pipe.sched.sched.sigmas_host, shape) if brownian
          else np.array(jax.random.normal(r_steps, (STEPS,) + shape)))
    want = np.asarray(jgen.inpaint_latents_cosine(
        jpipe.sched, jpair, jnp.asarray(w0), jnp.asarray(mask), rng, 6.0,
        noises=jnp.asarray(zs) if brownian else None))
    got = tgen.inpaint_latents_cosine(pipe.sched, tpair, torch.from_numpy(w0),
                                      torch.from_numpy(mask), _normal(r_init, shape),
                                      _normal(r_keep, (STEPS,) + shape),
                                      torch.from_numpy(zs), 6.0)
    assert rel_err(to_np(got), want) < STUB_TOL
    assert torch.equal(got[:, :, :4], torch.from_numpy(w0)[:, :, :4])


def test_functions_check_noise_shapes(scheds):
    _, ts = scheds
    den = _stub_denoisers()[1]
    w0 = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="per-step noise"):
        tgen.text_to_audio_latents(ts, den, w0, torch.zeros((STEPS - 1,) + SHAPE))
    with pytest.raises(ValueError, match="keep noise"):
        tgen.inpaint_latents(ts, den, w0, w0, w0, torch.zeros((1,) + SHAPE),
                             torch.zeros((STEPS,) + SHAPE))


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_region_is_the_source_latent_bit_for_bit(model_id, dtype):
    """Through a tiny model in float32 and bfloat16: outside the mask the
    inpainted latent is w0, bit for bit."""
    pipe = load_model(model_id, STEPS, device="cpu", dtype=dtype, seed=1)
    g = torch.Generator().manual_seed(0)
    uncond, cond = pipe.encode_text([""], negative=True), pipe.encode_text(["a cello"])
    if model_id == "test/tiny-stable-audio":
        shape = (1, pipe.dit.config.in_channels, pipe.sample_size)
        w0 = torch.randn(shape, generator=g).to(dtype)
        mask = torch.from_numpy(_mask(shape, 2, 3, 9))
        w = tgen.inpaint_latents_cosine(
            pipe.sched, pipe.make_eps_pair(uncond, cond), w0, mask,
            *(torch.randn(s, generator=g) for s in (shape, (STEPS,) + shape,
                                                    (STEPS,) + shape)), 5.0)
    else:
        shape = (1, pipe.unet.config.in_channels, 8, 4)
        w0 = torch.randn(shape, generator=g)
        mask = torch.from_numpy(_mask(shape, 2, 2, 6))
        from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors

        den = pipe.make_denoiser(uncond, cond, build_cfg_tensors(shape, ["a cello"], [5.0])[0])
        w = tgen.inpaint_latents(pipe.sched, den, w0, mask,
                                 *(torch.randn(s, generator=g) for s in
                                   (shape, (STEPS,) + shape, (STEPS,) + shape)))
    keep = mask == 0
    assert w.dtype == torch.float32 and torch.isfinite(w).all()
    assert torch.equal(w[keep], w0.float()[keep])
    assert not torch.equal(w[~keep], w0.float()[~keep])


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("aud")
    return (write_test_wav(str(d / "clip.wav"), seconds=0.3),
            write_stereo_wav(str(d / "stereo.wav"), seconds=0.05))


def _inject_mel_draws(monkeypatch, seed, mode):
    """The port CLI's editing function gets the draws of the JAX CLI's call
    from the key PRNGKey(seed)."""
    rng = jax.random.PRNGKey(seed)
    if mode == "generation":
        real = tcli.text_to_audio_latents

        def fake(sched, den, noise, zs, eta=1.0):
            r_init, r_steps = jax.random.split(rng)
            return real(sched, den, _normal(r_init, noise.shape), _normal(r_steps, zs.shape),
                        eta=eta)

        monkeypatch.setattr(tcli, "text_to_audio_latents", fake)
    elif mode == "transfer":
        real = tcli.style_transfer_latents

        def fake(sched, den, w0, noise, zs, strength, eta=1.0):
            r_noise, r_steps = jax.random.split(rng)
            return real(sched, den, w0, _normal(r_noise, noise.shape),
                        _normal(jax.random.split(r_steps)[1], zs.shape), strength, eta=eta)

        monkeypatch.setattr(tcli, "style_transfer_latents", fake)
    else:
        real = tcli.inpaint_latents

        def fake(sched, den, w0, mask, noise, keep, zs, eta=1.0):
            r_init, r_keep, r_steps = jax.random.split(rng, 3)
            return real(sched, den, w0, mask, _normal(r_init, noise.shape),
                        _normal(r_keep, keep.shape), _normal(r_steps, zs.shape), eta=eta)

        monkeypatch.setattr(tcli, "inpaint_latents", fake)


def _run_both(argv, tmp_path):
    j = jcli.main(argv + ["--save_path", str(tmp_path / "jax")])
    t = tcli.main(argv + ["--device", "cpu", "--save_path", str(tmp_path / "port")])
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert results_layout(a, tmp_path / "port") == results_layout(b, tmp_path / "jax")
        wav_close(a, b, CHAIN_TOL)
    return t


@pytest.mark.parametrize("mode,extra", [
    ("generation", ["-n", "2"]),
    ("transfer", ["--transfer_strength", "0.5"]),
    ("inpaint", ["--inpaint_window", "0.05", "0.2"]),
    ("sr", []),
])
def test_cli_matches_jax_cli_mel(clips, tmp_path, monkeypatch, mode, extra):
    """Each mode on test/tiny-audioldm: the same output names, the same
    wavs; -n 2 candidates run one at a time through the CFG denoiser."""
    seed = 4
    monkeypatch.setattr(tcli, "load_model", bridged_loader("test/tiny-audioldm", STEPS))
    _inject_mel_draws(monkeypatch, seed, mode)
    argv = ["--model_id", "test/tiny-audioldm", "-t", "a dog barking", "--ddim_steps",
            str(STEPS), "-dur", "0.3", "--seed", str(seed), "--mode", mode] + extra
    if mode != "generation":
        argv += ["-f", clips[0]]
    outs = _run_both(argv, tmp_path)
    import json

    with open(os.path.join(os.path.dirname(outs[0]), "run_args.json")) as f:
        rec = json.load(f)
    n = 2 if mode == "generation" else 1
    assert rec["unet_steps"] == n * (STEPS // 2 if mode == "transfer" else STEPS)
    assert rec.get("kept_region_bit_exact", True) is True
    if mode == "sr":
        assert rec["freq_mask_ratio"] == [0.75, 1.0]


@pytest.mark.parametrize("mode", ["generation", "inpaint"])
def test_cli_matches_jax_cli_stable_audio(clips, tmp_path, monkeypatch, mode):
    """Generation and inpainting on test/tiny-stable-audio with the
    Brownian per-step noise (bit-equal in both packages) and the JAX start,
    kept-region and latent-sample draws: the same output names, rate and
    shape, and the same latent decoded (not the wav:
    test_torch_helpers.record_stable_audio_decodes says why)."""
    from scipy.io import wavfile

    seed = 6
    jpipe = jax_tiny_stable_audio(STEPS)
    load = bridged_loader("test/tiny-stable-audio", STEPS)
    rng = jax.random.PRNGKey(seed)
    latents = record_stable_audio_decodes(monkeypatch)
    if mode == "inpaint":
        rng, enc_rng = jax.random.split(rng)

        def load_enc(*a, **kw):
            pipe = load(*a, **kw)
            real_enc = type(pipe).vae_encode
            pipe.vae_encode = lambda x, noise=None: real_enc(pipe, x, jax_vae_noise(jpipe, 1,
                                                                                    enc_rng))
            return pipe

        monkeypatch.setattr(tcli, "load_model", load_enc)
        real = tcli.inpaint_latents_cosine

        def fake(solver, pair, w0, mask, noise, keep, zs, cfg):
            r_init, r_keep, _ = jax.random.split(rng, 3)
            return real(solver, pair, w0, mask, _normal(r_init, noise.shape),
                        _normal(r_keep, keep.shape), zs, cfg)

        monkeypatch.setattr(tcli, "inpaint_latents_cosine", fake)
    else:
        monkeypatch.setattr(tcli, "load_model", load)
        real = tcli.sdedit_loop_cosine

        def fake(solver, pair, w0, noise, zs, skip, cfg_tar):
            return real(solver, pair, w0, _normal(jax.random.split(rng)[0], noise.shape), zs,
                        skip=skip, cfg_tar=cfg_tar)

        monkeypatch.setattr(tcli, "sdedit_loop_cosine", fake)
    argv = ["--model_id", "test/tiny-stable-audio", "-t", "a cello", "--ddim_steps",
            str(STEPS), "--seed", str(seed), "--mode", mode]
    if mode == "inpaint":
        argv += ["-f", clips[1], "--time_mask_ratio", "0.25", "0.75"]
    j = jcli.main(argv + ["--save_path", str(tmp_path / "jax")])
    t = tcli.main(argv + ["--device", "cpu", "--save_path", str(tmp_path / "port")])
    assert results_layout(t[0], tmp_path / "port") == results_layout(j[0], tmp_path / "jax")
    (sa, a), (sb, b) = wavfile.read(t[0]), wavfile.read(j[0])
    assert sa == sb and a.shape == b.shape and np.any(a)
    assert len(latents["jax"]) == len(latents["port"]) == 1
    assert rel_err(latents["port"][0], latents["jax"][0]) < CHAIN_TOL


def test_transfer_strength_zero_gives_back_the_vae_round_trip(clips, tmp_path):
    """--transfer_strength 0 runs no step: the wav is the VAE round trip of
    the input, vocoded."""
    from scipy.io import wavfile

    from audioeditingcode_tpu_torch.utils.audio_io import load_audio

    out = tcli.main(["--device", "cpu", "--model_id", "test/tiny-audioldm", "-t", "a dog",
                     "--ddim_steps", "6", "-f", clips[0], "--transfer_strength", "0",
                     "--save_path", str(tmp_path)])
    pipe = load_model("test/tiny-audioldm", 6, device="cpu", seed=42)
    x0, _, _ = load_audio(clips[0], pipe.mel_config)
    audio = to_np(pipe.decode_latent_to_waveform(pipe.vae_encode(torch.from_numpy(x0))))
    sr, got = wavfile.read(out[0])
    want = (np.clip(audio[0], -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.float64)
    assert sr == 16000 and got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want).max() <= 1


def test_stable_audio_transfer_strength_zero_runs_no_step(clips, tmp_path):
    """With Brownian noise (the default) the JAX CLI raises at strength 0:
    it asks the Brownian path for the increments of a schedule of one sigma.
    The port draws no noise for a loop of no step and gives back the VAE
    round trip, as both CLIs do with --noise_sampler iid (ROADMAP Queue C)."""
    import json

    argv = ["--model_id", "test/tiny-stable-audio", "-t", "a cello", "--ddim_steps", "6",
            "-f", clips[1], "--transfer_strength", "0"]
    with pytest.raises(ValueError, match="sigmas must be 1-D with >=2 entries"):
        jcli.main(argv + ["--save_path", str(tmp_path / "jax")])
    out = tcli.main(argv + ["--device", "cpu", "--save_path", str(tmp_path / "port")])
    with open(os.path.join(os.path.dirname(out[0]), "run_args.json")) as f:
        assert json.load(f)["unet_steps"] == 0


@pytest.mark.parametrize("argv,error,match", [
    (["--model_id", "test/tiny-stable-audio", "--mode", "sr"], NotImplementedError,
     "waveform codes"),
    (["--model_id", "test/tiny-audioldm", "--mode", "inpaint", "--inpaint_window", "5", "6"],
     ValueError, "selects nothing"),
    (["--model_id", "test/tiny-stable-audio", "--mode", "inpaint", "--inpaint_window", "5",
      "6"], ValueError, "selects nothing"),
    (["--model_id", "test/tiny-audioldm", "--mode", "transfer", "-f", "missing.wav"],
     FileNotFoundError, "missing.wav"),
    # an image model: it runs, and its decode has no vocoder, as in JAX
    (["--model_id", "test/tiny-sd"], ValueError, "has no vocoder"),
])
def test_cli_errors(clips, tmp_path, argv, error, match):
    if "--mode" in argv and "inpaint" in argv:
        argv = argv + ["-f", clips[1] if "stable" in argv[1] else clips[0]]
    with pytest.raises(error, match=match):
        tcli.main(["--device", "cpu", "--ddim_steps", "4", "--save_path", str(tmp_path)]
                  + argv)
