"""The slice as a whole on test/tiny-audioldm: wav -> mel -> VAE encode ->
inversion (forward pass) -> edit (reverse pass) -> VAE decode -> HiFi-GAN,
through the JAX functions and through the port, on the same wav, the same
params and the same inversion noise (the JAX draw, passed to the port).

Each side runs its whole chain on its own outputs, so float32 roundoff of
the two frameworks compounds over the steps (the largest error, ~5e-5, is
on the output wav); the stated tolerance is 2e-4 relative (max abs error
over max abs value) on every intermediate and on the output wav."""

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
    jax_tiny_pipeline,
    port_tiny_pipeline,
    rel_err,
    to_np,
    write_test_wav,
)

STEPS = 8
TOL = 2e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    wav = write_test_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"), seconds=0.7)
    jpipe = jax_tiny_pipeline(STEPS)
    return wav, jpipe, port_tiny_pipeline(STEPS, jpipe)


def _edit_jax(jpipe, wav, src, tgts, cfg_src, cfg_tar, tstart, seed):
    x0, _, _ = jio.load_audio(wav, jpipe.mel_config)
    w0 = jpipe.vae_encode(jnp.asarray(x0))
    empty = jpipe.encode_text([""], negative=True)
    uncond = jpipe.encode_text([""], negative=True)
    src_c = jpipe.encode_text([src]) if src else None
    tgt_c = jpipe.encode_text(tgts)
    cs, _ = jcfg.build_cfg_tensors(w0.shape, [src], cfg_src, zero_empty_prompts=True)
    ct, masks = jcfg.build_cfg_tensors(w0.shape, tgts, cfg_tar)
    rng = jax.random.PRNGKey(seed)
    _, zs, xts = jinv.inversion_forward_process(
        jpipe.sched, jpipe.make_denoiser(empty, src_c, cs), w0, rng)
    T = max(tstart)
    multi = len(tgts) > 1
    w = jinv.inversion_reverse_process(
        jpipe.sched, jpipe.make_denoiser(uncond, tgt_c, ct), xts, zs[:T],
        tstart=jnp.asarray(tstart) if multi else None, masks=masks if multi else None)
    x_dec = jpipe.vae_decode(w)
    noise = np.array(jax.random.normal(rng, (STEPS,) + w0.shape, dtype=w0.dtype))
    out = dict(x0=x0, w0=w0, zs=zs, xts=xts, w_edit=w, x_dec=x_dec,
               wav=jpipe.decode_to_mel(x_dec))
    return {k: np.asarray(v) for k, v in out.items()}, noise


def _edit_port(pipe, wav, src, tgts, cfg_src, cfg_tar, tstart, noise):
    x0, _, _ = tio.load_audio(wav, pipe.mel_config)
    w0 = pipe.vae_encode(torch.from_numpy(x0))
    empty = pipe.encode_text([""], negative=True)
    uncond = pipe.encode_text([""], negative=True)
    src_c = pipe.encode_text([src]) if src else None
    tgt_c = pipe.encode_text(tgts)
    cs, _ = tcfg.build_cfg_tensors(w0.shape, [src], cfg_src, zero_empty_prompts=True)
    ct, masks = tcfg.build_cfg_tensors(w0.shape, tgts, cfg_tar)
    _, zs, xts = tinv.inversion_forward_process(
        pipe.sched, pipe.make_denoiser(empty, src_c, cs), w0, torch.from_numpy(noise))
    T = max(tstart)
    multi = len(tgts) > 1
    w = tinv.inversion_reverse_process(
        pipe.sched, pipe.make_denoiser(uncond, tgt_c, ct), xts, zs[:T],
        tstart=torch.tensor(tstart) if multi else None, masks=masks if multi else None)
    x_dec = pipe.vae_decode(w)
    out = dict(x0=torch.from_numpy(x0), w0=w0, zs=zs, xts=xts, w_edit=w, x_dec=x_dec,
               wav=pipe.decode_to_mel(x_dec))
    return {k: to_np(v) for k, v in out.items()}


@pytest.mark.parametrize("src,tgts,cfg_src,cfg_tar,tstart", [
    ("a sine tone", ["a trumpet"], [3.0], [12.0], [6]),
    ("", ["a trumpet", "a violin"], [3.0], [12.0, 6.0], [6, 4]),
])
def test_edit_matches_jax(setup, src, tgts, cfg_src, cfg_tar, tstart):
    wav, jpipe, pipe = setup
    want, noise = _edit_jax(jpipe, wav, src, tgts, cfg_src, cfg_tar, tstart, seed=7)
    got = _edit_port(pipe, wav, src, tgts, cfg_src, cfg_tar, tstart, noise)
    errs = {k: rel_err(got[k], want[k]) for k in want}
    assert max(errs.values()) < TOL, errs
    assert np.all(got["zs"][0] == 0)
