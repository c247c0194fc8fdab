"""The port's CLIs with ``--weights_dir`` against the JAX CLIs on the CPU,
on converted tiny checkpoints (tests/test_torch_helpers.py::
build_converted_checkpoint): ``cli/run.py`` on test/tiny-audioldm,
test/tiny-audioldm2 and test/tiny-stable-audio; test/tiny-tango's edit
(no CLI choice in either package); SDEdit and the PC CLIs; the errors of a
missing or partial checkpoint. tests/test_torch_weights_load.py holds the
loads, the conditioning and a denoiser forward.

Tolerances: the CLI wavs within one int16 LSB beside 2e-4 relative, as
tests/test_torch_baselines.py holds them; TANGO's edit latent and wav 2e-4
relative. The two CLIs draw their noise differently (jax.random, torch), so
the port CLI is handed the JAX CLI's draws, taken from the same keys."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audioeditingcode_tpu.cli import run as jrun
from audioeditingcode_tpu.editing.cfg import build_cfg_tensors as jcfg
from audioeditingcode_tpu.models.registry import load_model as jload
from audioeditingcode_tpu_torch.cli import pc_apply as tpa
from audioeditingcode_tpu_torch.cli import pc_extract as tpe
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.cli import sdedit as tsd
from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors as tcfg
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
from test_torch_helpers import CKPT_STEPS, rel_err, to_np, write_stereo_wav, write_test_wav
from test_torch_helpers import converted_dirs as ckpt  # noqa: F401

STEPS = CKPT_STEPS
WAV_TOL = 2e-4


def _jax_draws(pipe, model_id, seed):
    """The noise of the JAX CLI's run: its key, split once for the Stable
    Audio latent sample."""
    rng = jax.random.PRNGKey(seed)
    enc = None
    if model_id == "test/tiny-stable-audio":
        rng, enc_rng = jax.random.split(rng)
        L, C = pipe.sample_size, pipe.vae.config.decoder_input_channels
        enc = np.asarray(jax.random.normal(enc_rng, (1, L, C))).transpose(0, 2, 1).copy()
    return rng, enc


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-audioldm2",
                                      "test/tiny-stable-audio"])
def test_cli_matches_jax_cli(ckpt, model_id, tmp_path, monkeypatch):
    """``cli/run.py --weights_dir`` against the JAX CLI on the same
    directory: the same results layout and run_args, the same wav."""
    wd = ckpt(model_id)
    sa = model_id == "test/tiny-stable-audio"
    wav = (write_stereo_wav if sa else write_test_wav)(str(tmp_path / "clip.wav"),
                                                     seconds=0.3)
    seed = 3
    real_load, real_inv = trun.load_model, trun.inversion_forward_process
    draws = {}

    def load(*a, **kw):
        assert kw["weights_dir"] == wd
        pipe = real_load(*a, **kw)
        draws["rng"], enc = _jax_draws(pipe, model_id, seed)
        if sa:
            real_enc = pipe.vae_encode
            pipe.vae_encode = lambda x, noise=None: real_enc(x, torch.from_numpy(enc))
        return pipe

    def inv(sched, den, w0, noise, **kw):
        z = np.asarray(jax.random.normal(draws["rng"], (STEPS,) + tuple(w0.shape)))
        return real_inv(sched, den, w0, torch.from_numpy(z.copy()), **kw)

    monkeypatch.setattr(trun, "load_model", load)
    monkeypatch.setattr(trun, "inversion_forward_process", inv)
    argv = ["--model_id", model_id, "--init_aud", wav, "--weights_dir", wd,
            "--num_diffusion_steps", str(STEPS), "--tstart", "4", "--seed", str(seed),
            "--source_prompt", "a sine tone", "--target_prompt", "a loud trumpet"]
    j = jrun.main(argv + ["--results_path", str(tmp_path / "jax")])
    t = trun.main(argv + ["--device", "cpu", "--results_path", str(tmp_path / "port")])
    assert (os.path.relpath(t, tmp_path / "port").split(os.sep)[:-1]
            == os.path.relpath(j, tmp_path / "jax").split(os.sep)[:-1])
    (sa_, a), (sb, b) = wavfile.read(t), wavfile.read(j)
    assert sa_ == sb and a.shape == b.shape and np.any(b)
    a, b = a.astype(np.float64), b.astype(np.float64)
    assert np.abs(a - b).max() <= 1 + WAV_TOL * np.abs(b).max(), np.abs(a - b).max()
    with open(os.path.join(os.path.dirname(t), "run_args.json")) as f:
        assert json.load(f)["weights_dir"] == wd


def test_tango_edit_matches_jax(ckpt, tmp_path):
    """test/tiny-tango is no CLI choice (in either package): its edit, the
    CLI's stages on the loaded pipelines, with the JAX draw."""
    from audioeditingcode_tpu.editing import invert as jinv
    from audioeditingcode_tpu.utils import audio_io as jio
    from audioeditingcode_tpu_torch.editing import invert as tinv

    wd = ckpt("test/tiny-tango")
    jpipe = jload("test/tiny-tango", STEPS, weights_dir=wd)
    pipe = treg.load_model("test/tiny-tango", STEPS, device="cpu", weights_dir=wd)
    x0, _, _ = jio.load_audio(write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3),
                              jpipe.mel_config)
    jw0 = jpipe.vae_encode(jnp.asarray(x0))
    tw0 = pipe.vae_encode(torch.from_numpy(x0))
    rng = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (STEPS,) + jw0.shape)))
    outs = []
    for p, cfg, inv, w0, nz in ((jpipe, jcfg, jinv, jw0, rng), (pipe, tcfg, tinv, tw0, noise)):
        empty = p.encode_text([""], negative=True)
        fwd = p.make_denoiser(empty, p.encode_text(["a sine tone"]),
                              cfg(w0.shape, ["a sine tone"], [3.0], zero_empty_prompts=True)[0])
        rev = p.make_denoiser(empty, p.encode_text(["a loud trumpet"]),
                              cfg(w0.shape, ["a loud trumpet"], [12.0])[0])
        _, zs, xts = inv.inversion_forward_process(p.sched, fwd, w0, nz)[:3]
        w = inv.inversion_reverse_process(p.sched, rev, xts, zs[:4])
        outs.append((w, p.decode_to_mel(p.vae_decode(w))))
    for want, got in zip(outs[0], outs[1]):
        assert rel_err(to_np(got), np.asarray(want)) < WAV_TOL


def test_other_clis_take_weights_dir(ckpt, tmp_path):
    """SDEdit and the PC CLIs run from a checkpoint; the PC application
    takes the extraction's weights_dir, as the JAX one does."""
    model_id = "test/tiny-audioldm2"
    wd = ckpt(model_id)
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    out = tsd.main(["--device", "cpu", "--model_id", model_id, "--init_aud", wav,
                    "--weights_dir", wd, "--num_diffusion_steps", "4", "--tstart", "3",
                    "--target_prompt", "a cello", "--results_path", str(tmp_path / "sd")])
    with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
        assert json.load(f)["weights_dir"] == wd
    ex = tpe.main(["--device", "cpu", "--model_id", model_id, "--init_aud", wav,
                   "--weights_dir", wd, "--num_diffusion_steps", "4", "--n_evs", "1",
                   "--drift_start", "3", "--drift_end", "2", "--iters", "2",
                   "--results_path", str(tmp_path / "pc")])
    seen = {}
    real_load = tpa.load_model

    def load(*a, **kw):
        seen["weights_dir"] = kw.get("weights_dir")
        return real_load(*a, **kw)

    tpa.load_model = load
    try:
        tpa.main(["--device", "cpu", "--extraction_path", ex, "--drift_start", "3",
                  "--drift_end", "2", "--evs", "1", "--amount", "1"])
    finally:
        tpa.load_model = real_load
    assert seen["weights_dir"] == wd


def test_missing_weights_raise(ckpt, tmp_path):
    """A missing model file raises; an absent text tower falls back to the
    null encoder as in the JAX registry; a part of the AudioLDM2 chain
    raises."""
    import shutil

    wd = ckpt("test/tiny-audioldm2")
    with pytest.raises(FileNotFoundError, match="unet.msgpack"):
        treg.load_model("test/tiny-audioldm2", 4, device="cpu", weights_dir=str(tmp_path))
    bare = tmp_path / "bare"
    bare.mkdir()
    for f in ("unet.msgpack", "vae.msgpack", "vocoder.msgpack"):
        shutil.copy(os.path.join(wd, f), bare / f)
    pipe = treg.load_model("test/tiny-audioldm2", 4, device="cpu", weights_dir=str(bare))
    assert isinstance(pipe.text_encoder, NullTextEncoder)
    shutil.copytree(os.path.join(wd, "t5"), bare / "t5")
    with pytest.raises(FileNotFoundError, match="gpt2.msgpack"):
        treg.load_model("test/tiny-audioldm2", 4, device="cpu", weights_dir=str(bare))
