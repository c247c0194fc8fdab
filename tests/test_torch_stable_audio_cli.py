"""The port's text-edit CLI on test/tiny-stable-audio, on the CPU: the JAX
CLI's results layout, a stereo wav at the model's rate, the selfcheck in
float32 and bfloat16, and --first_order."""

import json
import os

import numpy as np
import pytest
from scipy.io import wavfile

from audioeditingcode_tpu.cli.common import edit_save_path as jax_edit_save_path
from audioeditingcode_tpu_torch.cli.run import main
from test_torch_helpers import write_stereo_wav

TINY = "test/tiny-stable-audio"
BASE = ["--device", "cpu", "--model_id", TINY, "--num_diffusion_steps", "6",
        "--tstart", "4", "--seed", "0"]


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    return write_stereo_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"))


def _record(out):
    with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("extra", [[], ["--first_order"]])
def test_cli_selfcheck(wav, tmp_path, extra):
    out = main(BASE + ["--init_aud", wav, "--source_prompt", "a sine tone",
                       "--target_prompt", "a cello", "--selfcheck",
                       "--results_path", str(tmp_path)] + extra)
    d = os.path.dirname(out)
    assert d == jax_edit_save_path(str(tmp_path), TINY, wav, ["a sine tone"], ["a cello"], [""])
    name = os.path.basename(out)[: -len(".wav")]
    assert name.startswith("selfcheck_cfg_e_3_cfg_d_12_skip_2_")
    # no spectrogram on the waveform path
    assert sorted(os.listdir(d)) == sorted([name + ".wav", "orig.wav", "run_args.json"])
    rec = _record(out)
    assert rec["selfcheck_snr_db"] >= 40.0
    assert rec["unet_steps"] == 10 and rec["edit_seconds"] > 0 and rec["device"] == "cpu"
    assert rec["first_order"] == bool(extra)
    sr, audio = wavfile.read(out)
    # the clip is cropped to the tiny model's 64-sample window at 4 kHz
    assert sr == 4000 and audio.shape == (64, 2)


def test_cli_bfloat16_with_source(wav, tmp_path):
    """Mirrors tests/test_stable_audio.py::test_main_run_stable_audio_bf16_with_source:
    bf16 latents from the Oobleck encode, an f32 solver history."""
    out = main(BASE + ["--init_aud", wav, "--source_prompt", "a recording of music",
                       "--target_prompt", "a cello", "--dtype", "bfloat16",
                       "--results_path", str(tmp_path)])
    sr, audio = wavfile.read(out)
    assert sr == 4000 and audio.shape == (64, 2) and np.any(audio)
    rec = _record(out)
    assert rec["dtype"] == "bfloat16" and rec["selfcheck_snr_db"] is None
    check = main(BASE + ["--init_aud", wav, "--source_prompt", "a recording of music",
                         "--target_prompt", "a cello", "--dtype", "bfloat16", "--selfcheck",
                         "--results_path", str(tmp_path)])
    assert _record(check)["selfcheck_snr_db"] >= 40.0


def test_cli_multi_prompt_edit(wav, tmp_path):
    out = main(BASE + ["--init_aud", wav, "--target_prompt", "a cello", "a violin",
                       "--tstart", "4", "3", "--cfg_tar", "12", "6",
                       "--results_path", str(tmp_path)])
    assert wavfile.read(out)[1].shape == (64, 2)


def test_cli_ddim_mode_raises(wav, tmp_path):
    with pytest.raises(ValueError, match="cosine DPM solver"):
        main(BASE + ["--init_aud", wav, "--target_prompt", "x", "--mode", "ddim",
                     "--results_path", str(tmp_path)])
