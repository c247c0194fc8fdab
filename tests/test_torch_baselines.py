"""The DDIM-inversion baseline (``--mode ddim``) of the port against the JAX
package on the CPU: ``ddim_next_step``, the inversion and generation loops
on test/tiny-audioldm, and the CLI against the JAX CLI with the same
weights.

Tolerances: the step ~1e-6 (float32 elementwise math on the same arrays);
the loops and the CLI 2e-4 relative (max abs error over max abs value: a
chain of whole float32 forwards, each side on its own outputs, as the tiny
edits of tests/test_torch_e2e.py). The wavs of the two CLIs are int16, so
one LSB of rounding is allowed beside it."""

import json
import os
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audioeditingcode_tpu.cli import run as jrun
from audioeditingcode_tpu.editing import cfg as jcfg
from audioeditingcode_tpu.editing import ddim as jddim
from audioeditingcode_tpu.schedulers import ddim as jd
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.editing import cfg as tcfg
from audioeditingcode_tpu_torch.editing import ddim as tddim
from audioeditingcode_tpu_torch.schedulers import ddim as td
from audioeditingcode_tpu_torch.utils import audio_io as tio
from test_torch_helpers import (
    jax_tiny_pipeline,
    port_tiny_pipeline,
    rel_err,
    to_np,
    write_test_wav,
)

STEPS = 8
STEP_TOL = 2e-6
TOL = 2e-4
SCHEDS = {"audioldm": td.DDIMConfig(),
          # TANGO's v-prediction schedule: the step assumes epsilon all the same
          "tango_v": td.DDIMConfig(beta_start=0.00085, beta_end=0.012,
                                   prediction_type="v_prediction")}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    wav = write_test_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"), seconds=0.5)
    jpipe = jax_tiny_pipeline(STEPS)
    return wav, jpipe, port_tiny_pipeline(STEPS, jpipe)


@pytest.mark.parametrize("name", sorted(SCHEDS))
@pytest.mark.parametrize("k", [0, 1, 23, 49])
def test_ddim_next_step_matches_jax(name, k):
    """k = 49 is the last position, where the previous timestep is negative
    and step_alpha_prod_prev holds final_alpha_cumprod."""
    cfg = SCHEDS[name]
    js = jd.make_schedule(jd.DDIMConfig(**{f: getattr(cfg, f)
                                           for f in cfg.__dataclass_fields__}), 50)
    ts = td.make_schedule(cfg, 50)
    rng = np.random.default_rng(k)
    x, eps = (rng.standard_normal((1, 4, 8, 6), dtype=np.float32) for _ in range(2))
    want = np.asarray(jd.ddim_next_step(js, k, jnp.asarray(eps), jnp.asarray(x)))
    got = to_np(td.ddim_next_step(ts, k, torch.from_numpy(eps), torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("skip", [0, 3])
def test_ddim_loops_match_jax(setup, skip):
    """Inversion with the source prompt, then generation with the target,
    both packages on the same latent and params."""
    wav, jpipe, pipe = setup
    x0, _, _ = jio.load_audio(wav, jpipe.mel_config)
    jw0 = jpipe.vae_encode(jnp.asarray(x0))
    w0 = pipe.vae_encode(torch.from_numpy(x0))
    dens = []
    for p, cfg, w in ((jpipe, jcfg, jw0), (pipe, tcfg, w0)):
        empty = p.encode_text([""], negative=True)
        dens.append([p.make_denoiser(empty, p.encode_text([prompt]),
                                     cfg.build_cfg_tensors(w.shape, [prompt], [scale])[0])
                     for prompt, scale in (("a sine tone", 3.0), ("a trumpet", 12.0))])
    jT = jddim.ddim_inversion_loop(jpipe.sched, dens[0][0], jw0, skip=skip)
    tT = tddim.ddim_inversion_loop(pipe.sched, dens[1][0], w0, skip=skip)
    assert rel_err(to_np(tT), np.asarray(jT)) < TOL
    want = np.asarray(jddim.ddim_generation_loop(jpipe.sched, dens[0][1], jT, skip=skip))
    got = to_np(tddim.ddim_generation_loop(pipe.sched, dens[1][1], tT, skip=skip))
    assert rel_err(got, want) < TOL


def _bridged_loader(model_id, steps):
    """The port CLI's load_model, giving the JAX CLI's weights (the JAX CLI
    loads with seed 0) carried over by the bridge."""
    pipe = port_tiny_pipeline(steps, jax_tiny_pipeline(steps, model_id), model_id)

    def load(mid, num_steps, device="cpu", dtype=torch.float32, seed=0, weights_dir=None):
        assert (mid, num_steps, str(device), dtype) == (model_id, steps, "cpu", torch.float32)
        return pipe

    return load


def _wav_close(a_path, b_path):
    (sa, a), (sb, b) = wavfile.read(a_path), wavfile.read(b_path)
    assert sa == sb and a.shape == b.shape and np.any(a)
    a, b = a.astype(np.float64), b.astype(np.float64)
    assert np.abs(a - b).max() <= 1 + TOL * np.abs(b).max(), np.abs(a - b).max()


@pytest.mark.parametrize("tstart,selfcheck", [(6, False), (6, True), (8, False)])
def test_ddim_cli_matches_jax_cli(setup, tmp_path, monkeypatch, tstart, selfcheck):
    """The two CLIs on the same weights: the same file name and layout,
    the same wav, the same selfcheck SNR (labelled ddim-approx, taken
    against w0); tstart 8 runs the full inversion (no warning)."""
    wav = setup[0]
    monkeypatch.setattr(trun, "load_model", _bridged_loader("test/tiny-audioldm", STEPS))
    argv = ["--model_id", "test/tiny-audioldm", "--init_aud", wav, "--mode", "ddim",
            "--num_diffusion_steps", str(STEPS), "--tstart", str(tstart),
            "--source_prompt", "a sine tone", "--target_prompt", "a trumpet", "--seed", "0"]
    argv += ["--selfcheck"] if selfcheck else []
    outs = {}
    for name, main in (("jax", jrun.main), ("port", trun.main)):
        extra = ["--device", "cpu"] if name == "port" else []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs[name] = main(argv + extra + ["--results_path", str(tmp_path / name)])
        partial = [w for w in caught if issubclass(w.category, RuntimeWarning)
                   and "partial DDIM inversion" in str(w.message)]
        assert len(partial) == (tstart != STEPS), name
    j, t = outs["jax"], outs["port"]

    def layout(out, root):  # the results layout, timestamps dropped
        return (os.path.relpath(os.path.dirname(out), root),
                sorted(re.sub(r"_\d+\.", ".", f) for f in os.listdir(os.path.dirname(out))))

    assert layout(t, tmp_path / "port") == layout(j, tmp_path / "jax")
    _wav_close(t, j)
    recs = []
    for out in (j, t):
        with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
            recs.append(json.load(f))
    if selfcheck:
        assert os.path.basename(t).startswith("selfcheck_")
        assert abs(recs[1]["selfcheck_snr_db"] - recs[0]["selfcheck_snr_db"]) < 1e-2
    else:
        assert recs[1]["selfcheck_snr_db"] is None
    assert recs[1]["unet_steps"] == 2 * tstart and recs[1]["edit_seconds"] > 0


@pytest.mark.parametrize("extra,error", [
    (["--model_id", "test/tiny-stable-audio"], "cosine DPM solver"),
    (["--cfg_tar", "12", "6"], "one cfg scale value"),
    (["--cfg_src", "3", "4"], "one cfg scale value"),
    (["--target_prompt", "a trumpet", "a violin"], "single prompts"),
])
def test_ddim_cli_errors(setup, tmp_path, extra, error):
    """The JAX CLI's three --mode ddim errors, raised before a model loads."""
    argv = ["--device", "cpu", "--model_id", "test/tiny-audioldm", "--init_aud", setup[0],
            "--mode", "ddim", "--num_diffusion_steps", "6", "--tstart", "6",
            "--target_prompt", "a trumpet", "--results_path", str(tmp_path)]
    with pytest.raises(ValueError, match=error):
        trun.main(argv + extra)


def test_ddim_cli_selfcheck_labels_ddim_approx(setup, tmp_path, capsys):
    out = trun.main(["--device", "cpu", "--model_id", "test/tiny-audioldm",
                     "--init_aud", setup[0], "--mode", "ddim", "--num_diffusion_steps", "6",
                     "--tstart", "6", "--target_prompt", "a trumpet", "--selfcheck",
                     "--results_path", str(tmp_path)])
    assert "(ddim-approx)" in capsys.readouterr().out
    name = os.path.basename(out)
    assert name.startswith("selfcheck_cfg_e_3_cfg_d_12_6timesteps_")


def test_ddim_on_v_prediction_matches_jax(tmp_path):
    """--mode ddim on a v-prediction model (TANGO): the inversion step
    assumes epsilon in both packages, and the loops agree."""
    jpipe = jax_tiny_pipeline(6, "test/tiny-tango")
    pipe = port_tiny_pipeline(6, jpipe, "test/tiny-tango")
    assert pipe.sched.prediction_type == "v_prediction"
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    x0, _, _ = tio.load_audio(wav, pipe.mel_config)
    jw0 = jpipe.vae_encode(jnp.asarray(x0))
    w0 = pipe.vae_encode(torch.from_numpy(x0))
    jden = jpipe.make_denoiser(jpipe.encode_text([""], negative=True),
                               jpipe.encode_text(["a trumpet"]),
                               jcfg.build_cfg_tensors(jw0.shape, ["a trumpet"], [3.0])[0])
    tden = pipe.make_denoiser(pipe.encode_text([""], negative=True),
                              pipe.encode_text(["a trumpet"]),
                              tcfg.build_cfg_tensors(w0.shape, ["a trumpet"], [3.0])[0])
    jT = jddim.ddim_inversion_loop(jpipe.sched, jden, jw0, skip=1)
    want = np.asarray(jddim.ddim_generation_loop(jpipe.sched, jden, jT, skip=1))
    tT = tddim.ddim_inversion_loop(pipe.sched, tden, w0, skip=1)
    got = to_np(tddim.ddim_generation_loop(pipe.sched, tden, tT, skip=1))
    assert rel_err(to_np(tT), np.asarray(jT)) < TOL
    assert rel_err(got, want) < TOL
