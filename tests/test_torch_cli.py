"""The port's text-edit CLI on the CPU: the JAX CLI's results layout, the
selfcheck, and clear errors for what this port does not cover yet."""

import json
import os

import pytest
import torch

from audioeditingcode_tpu.cli.common import edit_save_path as jax_edit_save_path
from audioeditingcode_tpu_torch.cli.run import main
from test_torch_helpers import write_test_wav

BASE = ["--model_id", "test/tiny-audioldm", "--num_diffusion_steps", "6",
        "--tstart", "4", "--seed", "0"]


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    return write_test_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"), seconds=0.5)


def test_cli_selfcheck_on_cpu(wav, tmp_path):
    out = main(BASE + ["--device", "cpu", "--init_aud", wav, "--target_prompt", "a trumpet",
                       "--source_prompt", "a sine tone", "--selfcheck",
                       "--results_path", str(tmp_path)])
    d = os.path.dirname(out)
    assert d == jax_edit_save_path(str(tmp_path), "test/tiny-audioldm", wav,
                                   ["a sine tone"], ["a trumpet"], [""])
    name = os.path.basename(out)[: -len(".wav")]
    assert name.startswith("selfcheck_cfg_e_3_cfg_d_12_skip_2_")
    assert sorted(os.listdir(d)) == sorted([name + ".wav", name + ".png", "orig.wav",
                                            "run_args.json"])
    with open(os.path.join(d, "run_args.json")) as f:
        rec = json.load(f)
    assert rec["selfcheck_snr_db"] >= 40.0
    assert rec["device"] == "cpu" and rec["unet_steps"] == 10 and rec["seed"] == 0


def test_cli_multi_prompt_edit_on_cpu(wav, tmp_path):
    out = main(BASE + ["--device", "cpu", "--init_aud", wav,
                       "--target_prompt", "a trumpet", "a violin", "--tstart", "4", "3",
                       "--cfg_tar", "12", "6", "--results_path", str(tmp_path)])
    assert os.path.getsize(out) > 44


def test_cli_cuda_missing_raises(wav, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(BASE + ["--init_aud", wav, "--target_prompt", "x",
                     "--results_path", str(tmp_path)])


@pytest.mark.parametrize("extra,error,match", [
    # --dp/--tp/--sp are ported (tests/test_torch_parallel_cli.py): two ranks
    # on a machine of one card raise before any rank starts, and --sp 2 on a
    # mel family raises the JAX CLI's ValueError
    (["--dp", "2", "--device", "cuda"], ValueError, "CUDA device"),
    (["--sp", "2"], ValueError, "requires a stable-audio model"),
    # --profile_dir is ported (tests/test_torch_evals_cli.py); --tp 2 asks
    # for two cards as --dp 2 does
    (["--tp", "2", "--device", "cuda"], ValueError, "CUDA device"),
])
def test_cli_unported_flags_raise(wav, tmp_path, monkeypatch, extra, error, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(error, match=match):
        main(BASE + ["--device", "cpu", "--init_aud", wav, "--target_prompt", "x",
                     "--results_path", str(tmp_path)] + extra)


def test_cli_bfloat16_on_cpu(wav, tmp_path):
    """--dtype bfloat16 runs the modules in bf16; latents and the schedule
    math stay float32, so the inversion still reconstructs."""
    out = main(BASE + ["--device", "cpu", "--dtype", "bfloat16", "--init_aud", wav,
                       "--target_prompt", "a trumpet", "--selfcheck",
                       "--results_path", str(tmp_path)])
    with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
        assert json.load(f)["selfcheck_snr_db"] >= 40.0
