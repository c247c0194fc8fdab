"""The Stable Audio slice as a whole on test/tiny-stable-audio: wav ->
waveform -> Oobleck encode -> inversion (forward pass) -> edit (reverse
pass, warm-started with the forward pass's solver history) -> Oobleck
decode, through the JAX functions and through the port, on the same wav, the
same params and the same noise (the JAX draws, passed to the port).

Tolerances (max abs error over max abs value):
- each side running its chain on its own outputs: 5e-3 on the latent, the
  noise maps, the trajectory, the solver history and the edited latent
  (measured ~1.5e-3). The bound is set by the random-weight Oobleck VAE,
  whose float32 encode is ~5e-4 from its float64 result in either framework
  (tests/test_torch_stable_audio_modules.py). Its decoder amplifies an
  input difference ~50x (the Snake activations of a latent of large
  values), so the waveforms are compared on the same latent: 3e-3;
- the inversion and the edit started from the same latent: 1e-4 (measured
  ~1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.editing import cfg as jcfg
from audioeditingcode_tpu.editing import invert as jinv
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.editing import cfg as tcfg
from audioeditingcode_tpu_torch.editing import invert as tinv
from audioeditingcode_tpu_torch.utils import audio_io as tio
from test_torch_helpers import (
    jax_tiny_stable_audio,
    port_tiny_stable_audio,
    rel_err,
    to_np,
    write_stereo_wav,
)

STEPS = 8
CHAIN_TOL = 5e-3
DECODE_TOL = 3e-3
LOOP_TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    wav = write_stereo_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"))
    jpipe = jax_tiny_stable_audio(STEPS)
    return wav, jpipe, port_tiny_stable_audio(STEPS, jpipe)


def _conds(pipe, src, tgts):
    empty = pipe.encode_text([""], negative=True)
    return empty, empty, pipe.encode_text([src]) if src else None, pipe.encode_text(tgts)


def _loops_jax(jpipe, w0, rng, src, tgts, cfg_src, cfg_tar, tstart):
    empty, uncond, src_c, tgt_c = _conds(jpipe, src, tgts)
    cs, _ = jcfg.build_cfg_tensors(w0.shape, [src], cfg_src, zero_empty_prompts=True)
    ct, masks = jcfg.build_cfg_tensors(w0.shape, tgts, cfg_tar)
    _, zs, xts, ext = jinv.inversion_forward_process(
        jpipe.sched, jpipe.make_denoiser(empty, src_c, cs), w0, rng, return_extras=True)
    T, multi = max(tstart), len(tgts) > 1
    w = jinv.inversion_reverse_process(
        jpipe.sched, jpipe.make_denoiser(uncond, tgt_c, ct), xts, zs[:T],
        tstart=jnp.asarray(tstart) if multi else None, masks=masks if multi else None,
        init_history=ext[T - 1])
    return dict(zs=zs, xts=xts, extras=ext, w_edit=w)


def _loops_port(pipe, w0, noise, src, tgts, cfg_src, cfg_tar, tstart):
    empty, uncond, src_c, tgt_c = _conds(pipe, src, tgts)
    cs, _ = tcfg.build_cfg_tensors(w0.shape, [src], cfg_src, zero_empty_prompts=True)
    ct, masks = tcfg.build_cfg_tensors(w0.shape, tgts, cfg_tar)
    _, zs, xts, ext = tinv.inversion_forward_process(
        pipe.sched, pipe.make_denoiser(empty, src_c, cs), w0, noise, return_extras=True)
    T, multi = max(tstart), len(tgts) > 1
    w = tinv.inversion_reverse_process(
        pipe.sched, pipe.make_denoiser(uncond, tgt_c, ct), xts, zs[:T],
        tstart=torch.tensor(tstart) if multi else None, masks=masks if multi else None,
        init_history=ext[T - 1])
    return dict(zs=zs, xts=xts, extras=ext, w_edit=w)


CASES = [
    ("a sine tone", ["a cello"], [3.0], [12.0], [6]),
    ("", ["a cello", "a violin"], [3.0], [12.0, 6.0], [6, 4]),
]


@pytest.mark.parametrize("src,tgts,cfg_src,cfg_tar,tstart", CASES)
def test_edit_matches_jax(setup, src, tgts, cfg_src, cfg_tar, tstart):
    wav, jpipe, pipe = setup
    # JAX: the CLI's stages with explicit keys
    x0, sr, dur = jio.load_audio(wav, None, stft=False, model_sr=jpipe.get_sr())
    x0_t, sr_t, dur_t = tio.load_audio(wav, None, stft=False, model_sr=pipe.get_sr())
    assert (sr, dur) == (sr_t, dur_t) and x0.shape == (2, 4000)
    np.testing.assert_allclose(x0_t, x0, rtol=1e-6, atol=1e-7)
    max_s = jpipe.audio_vae_length / jpipe.sample_rate
    jpipe.setup_duration(0.0, min(dur, max_s))
    pipe.setup_duration(0.0, min(dur_t, max_s))
    enc_rng, rng = jax.random.split(jax.random.PRNGKey(7))
    w0 = jpipe.vae_encode(jnp.asarray(x0), rng=enc_rng)
    want = _loops_jax(jpipe, w0, rng, src, tgts, cfg_src, cfg_tar, tstart)
    want.update(w0=w0, wav=jpipe.vae_decode(want["w_edit"]))

    # the port, with the JAX draws: the latent sample's (in (B, L, C), the
    # Flax layout) and the trajectory's
    L, C = jpipe.sample_size, jpipe.vae.config.decoder_input_channels
    enc_noise = np.asarray(jax.random.normal(enc_rng, (1, L, C))).transpose(0, 2, 1)
    xts_noise = np.asarray(jax.random.normal(rng, (STEPS,) + w0.shape))
    tw0 = pipe.vae_encode(torch.from_numpy(x0_t), torch.from_numpy(enc_noise.copy()))
    got = _loops_port(pipe, tw0, torch.from_numpy(xts_noise.copy()), src, tgts, cfg_src, cfg_tar,
                      tstart)
    got.update(w0=tw0, wav=pipe.vae_decode(got["w_edit"]))
    errs = {k: rel_err(to_np(got[k]), np.asarray(want[k])) for k in want if k != "wav"}
    assert max(errs.values()) < CHAIN_TOL, errs
    assert np.all(to_np(got["zs"][0]) == 0)
    assert got["wav"].shape == (1, 2, int(min(dur, max_s) * sr))
    wav_same = pipe.vae_decode(torch.from_numpy(np.array(want["w_edit"])))
    assert rel_err(to_np(wav_same), np.asarray(want["wav"])) < DECODE_TOL

    # the loops from the same (JAX) latent
    same = _loops_port(pipe, torch.from_numpy(np.array(w0)), torch.from_numpy(xts_noise.copy()),
                       src, tgts, cfg_src, cfg_tar, tstart)
    errs = {k: rel_err(to_np(same[k]), np.asarray(want[k])) for k in same}
    assert max(errs.values()) < LOOP_TOL, errs
    jpipe.setup_duration()
    pipe.setup_duration()
