"""The port's CLIs on several ranks (``--dp``, ``--tp``, ``--sp``) on the
CPU: the long-form edit at dp = 2 against dp = 1 and the JAX CLI, PC
extraction at dp = 2 (the ev batch, and the window steps of a chunk)
against dp = 1 and the JAX driver, batch and sequence-parallel edits
against one process, a real process group of one under ``--sp 1``, and
the launcher's rules (``parallel/launch.py``).

Tolerances: wavs within one int16 LSB of each other across dp (each rank
runs the same float32 ops on its block of windows; the ranks' CPU ops run
on one thread each, and may sum in another order than the test's process)
and, against the JAX CLI, one LSB beside 2e-4 of the peak
(tests/test_torch_longform.py); extraction at dp = 2 against dp = 1 and
against JAX, the bounds of tests/test_torch_pc_cli.py (its -c 0.1 probe
lifts float32 roundoff 10x a power iteration: two PCs in one batch-4
forward and one each in two batch-2 forwards part by up to 4e-3 relative
after 21 iterations, with |cosine| above 0.9999; the test runs 11). On Stable Audio the
random tiny Oobleck decoder lifts float32 differences ~4000x
(tests/test_torch_helpers.record_stable_audio_decodes), so its wavs are
held to 1e-2 of the peak.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import distributed as dist

from audioeditingcode_tpu.cli import pc_extract as jpe
from audioeditingcode_tpu.cli import run as jrun
from audioeditingcode_tpu.cli import run_long as jrl
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.cli import pc_extract as tpe
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.cli import run_batch as trb
from audioeditingcode_tpu_torch.cli import run_long as trl
from audioeditingcode_tpu_torch.ops import flash_attention as fa
from audioeditingcode_tpu_torch.parallel.launch import spawn
from test_torch_helpers import (
    REPO,
    bridged_loader,
    jax_row_noise,
    jax_tiny_pipeline,
    port_tiny_pipeline,
    rel_err,
    wav_close,
    write_stereo_wav,
    write_test_wav,
)
import test_torch_parallel_helpers as ranks

STEPS = 6
WAV_TOL = 2e-4
SA_WAV_TOL = 1e-2
JOIN_S = 180
MEL, SA = "test/tiny-audioldm", "test/tiny-stable-audio"


def _wav(path):
    from scipy.io import wavfile

    return wavfile.read(path)[1].astype(np.int64)


def test_run_long_dp2_matches_dp1_and_the_jax_cli(tmp_path, monkeypatch):
    """Three mel windows (a 0.9 s clip in 0.4 s chunks) split over two ranks
    (windows 0-1, then 2 and a repeat of it): the stitched wav within one
    LSB of the one-process edit, which matches the JAX CLI's at --dp 2; all
    three edits from the JAX CLI's weights and window draws."""
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.9)
    argv = ["--model_id", MEL, "--init_aud", wav, "--target_prompt", "a trumpet",
            "--source_prompt", "a sine tone", "--num_diffusion_steps", str(STEPS),
            "--tstart", "4", "--seed", "2", "--chunk_seconds", "0.4",
            "--overlap_seconds", "0.1"]
    load = bridged_loader(MEL, STEPS)
    monkeypatch.setattr(trl, "load_model", load)
    drawn = {}

    def noise(gen, S, w0):
        drawn["noise"] = jax_row_noise(jax.random.PRNGKey(2), S, w0)
        return drawn["noise"].clone()

    monkeypatch.setattr(trl, "_inversion_noise", noise)
    j = jrl.main(argv + ["--dp", "2", "--results_path", str(tmp_path / "jax")])
    one = trl.main(argv + ["--device", "cpu", "--results_path", str(tmp_path / "one")])
    wav_close(one, j, WAV_TOL)
    states = ranks.pipeline_states(load(MEL, STEPS))
    two = spawn(ranks.cli, 2, "run_long",
                argv + ["--device", "cpu", "--dp", "2", "--results_path", str(tmp_path / "two")],
                MEL, STEPS, states, drawn["noise"], timeout=JOIN_S)
    assert two[1] is None and os.path.exists(two[0])
    assert np.abs(_wav(two[0]) - _wav(one)).max() <= 1
    with open(os.path.join(os.path.dirname(two[0]), "run_args.json")) as f:
        rec = json.load(f)
    assert rec["n_windows"] == 3 and rec["mesh"] == {"dp": 2, "tp": 1}
    # only rank 0 wrote: one results directory, one wav and run_args.json
    assert sorted(os.listdir(tmp_path / "two")) == ["tiny-audioldm"]


def _jax_draws(key, w0, window: int, n_evs: int):
    """The JAX driver's draws from ``key`` (tests/test_torch_pc_cli.py)."""
    key, r_inv = jax.random.split(key)
    inv = np.array(jax.random.normal(r_inv, (STEPS,) + w0.shape, dtype=w0.dtype))
    v0s = []
    for _ in range(window):
        key, r_eig = jax.random.split(key)
        v0s.append(torch.from_numpy(np.array(
            jax.random.normal(r_eig, (n_evs,) + w0.shape[1:], dtype=w0.dtype))))
    return torch.from_numpy(inv), v0s


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))


@pytest.mark.parametrize("n_evs,ts_chunk", [(2, 1), (1, 2)])
def test_pc_extract_dp2_matches_dp1_and_jax(tmp_path, n_evs, ts_chunk):
    """PC extraction on tiny AudioLDM at dp = 2: at --ts_chunk 1 the two PCs
    of each window step split over the ranks (gathered before the QR), at
    --ts_chunk 2 the chunk's two window steps; against dp = 1 of the port
    and the JAX driver at dp = 2, all from the JAX draws."""
    clip = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    argv = ["--model_id", MEL, "--init_aud", clip, "--num_diffusion_steps", str(STEPS),
            "--drift_start", "4", "--drift_end", "2", "--iters", "11", "--n_evs",
            str(n_evs), "-c", "0.1", "--seed", "3", "--wandb_disable", "--source_prompt",
            "a sine tone", "--ts_chunk", str(ts_chunk), "--dp", "2"]
    jpipe = jax_tiny_pipeline(STEPS)
    tpipe = port_tiny_pipeline(STEPS, jpipe)
    x0, _, _ = jio.load_audio(clip, jpipe.mel_config, stft=True, model_sr=jpipe.get_sr())
    w0 = jpipe.vae_encode(jnp.asarray(x0))
    key = jax.random.PRNGKey(5)
    inv, v0s = _jax_draws(key, w0, window=2, n_evs=n_evs)
    tw0 = torch.from_numpy(np.array(w0))
    jargs = jpe.parse_args(argv)
    jargs._mesh = jrun.maybe_shard_pipeline(jpipe, 2, 1)
    jpath, _ = jpe.run_pc_extraction(jargs, jpipe, w0, key, 3.0, str(tmp_path), "jax", 3)
    one_args = tpe.parse_args(argv[:-2] + ["--device", "cpu"])
    one, _ = tpe.run_pc_extraction(one_args, tpipe, tw0, None, 3.0, str(tmp_path), "one", 3,
                                   inv_noise=inv, v0s=v0s)
    (d := tmp_path / "two").mkdir()
    two = spawn(ranks.pc_extraction, 2, MEL, STEPS, ranks.pipeline_states(tpipe), argv, tw0,
                inv, v0s, str(d), timeout=JOIN_S)
    assert two[1] is None and len(os.listdir(d)) == 1
    t = np.load(two[0])
    for ref in (np.load(one), np.load(jpath)):
        for f in ("latents", "xts", "norm_factors"):
            assert rel_err(t[f], ref[f]) <= 1e-4, f
        for w in range(2):
            for ev in range(n_evs):
                assert _cos(t["eig_vecs"][w, ev], ref["eig_vecs"][w, ev]) >= 0.9999, (w, ev)
        assert rel_err(t["eig_vals"], ref["eig_vals"]) <= 5e-4
        assert rel_err(t["in_norms"], ref["in_norms"]) <= 1e-4
        for f in ("in_corrs", "corrs"):
            assert t[f].shape == ref[f].shape and np.abs(t[f] - ref[f]).max() <= 3e-3, f


def _sa_argv(wav, tmp_path, name):
    return ["--device", "cpu", "--model_id", SA, "--init_aud", wav, "--source_prompt",
            "a sine tone", "--target_prompt", "a cello", "--num_diffusion_steps",
            str(STEPS), "--tstart", "4", "--seed", "0", "--selfcheck",
            "--results_path", str(tmp_path / name)]


def _run_args(out):
    with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
        return json.load(f)


def test_sp1_is_a_group_of_one_through_the_sp_route(tmp_path, monkeypatch):
    """--sp 1 builds a real process group of one in this process and sends
    the DiT's self-attention through the sp route (the dispatcher's
    threshold lowered to the tiny DiT's 17 tokens): the same edit as the
    run without --sp, to float32 roundoff (the selfcheck SNR alike)."""
    wav = write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05)
    monkeypatch.setattr(fa, "_MIN_SEQ_FOR_KERNEL", 8)
    calls, groups = [], []
    real = fa._sp_blocked_attention

    def counted(*a, **kw):
        calls.append(1)
        groups.append(dist.get_world_size())
        return real(*a, **kw)

    monkeypatch.setattr(fa, "_sp_blocked_attention", counted)
    plain = trun.main(_sa_argv(wav, tmp_path, "plain"))
    assert not calls
    sp1 = trun.main(_sa_argv(wav, tmp_path, "sp1") + ["--sp", "1"])
    assert not dist.is_initialized()  # the group is gone with the run
    forwards = _run_args(sp1)["unet_steps"]
    assert len(calls) == forwards * 2 and set(groups) == {1}  # 2 DiT layers
    assert _run_args(sp1)["mesh"] == {"dp": 1, "tp": 1, "sp": 1}
    wav_close(sp1, plain, SA_WAV_TOL)
    assert abs(_run_args(sp1)["selfcheck_snr_db"] - _run_args(plain)["selfcheck_snr_db"]) < 1


def test_sp2_tp2_edit_matches_one_process(tmp_path):
    """The Stable Audio edit CLI at --sp 2 and at --tp 2 (two ranks each,
    seeded weights): rank 0's wav against the one-process edit."""
    wav = write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05)
    one = trun.main(_sa_argv(wav, tmp_path, "one"))
    for flag in ("--sp", "--tp"):
        out = trun.main(_sa_argv(wav, tmp_path, flag[2:]) + [flag, "2"])
        assert _run_args(out)["mesh"] == ({"dp": 1, "tp": 1, "sp": 2} if flag == "--sp"
                                          else {"dp": 1, "tp": 2})
        wav_close(out, one, SA_WAV_TOL)


def test_run_batch_dp2_matches_dp1(tmp_path):
    """Three Stable Audio clips of different lengths over two ranks (clips
    0-1, then 2 and a repeat), each with its own duration rows: every clip's
    wav against the one-process batch edit."""
    d = tmp_path / "clips"
    d.mkdir()
    for i, s in enumerate((0.05, 0.03, 0.02)):
        write_stereo_wav(str(d / f"c{i}.wav"), seconds=s)
    argv = ["--device", "cpu", "--model_id", SA, "--init_aud", str(d), "--target_prompt",
            "a cello", "--num_diffusion_steps", str(STEPS), "--tstart", "4", "--seed", "1"]
    one = trb.main(argv + ["--results_path", str(tmp_path / "one")])
    two = trb.main(argv + ["--dp", "2", "--results_path", str(tmp_path / "two")])
    assert len(one) == len(two) == 3
    for a, b in zip(two, one):
        wav_close(a, b, SA_WAV_TOL)
        assert _run_args(a)["mesh"] == {"dp": 2, "tp": 1}


@pytest.mark.parametrize("cli", ["run", "run_long", "run_batch"])
def test_sp_above_one_on_a_mel_family_raises_the_jax_error(tmp_path, cli):
    import importlib

    module = importlib.import_module(f"audioeditingcode_tpu_torch.cli.{cli}")
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    with pytest.raises(ValueError, match="requires a stable-audio model"):
        module.main(["--device", "cpu", "--model_id", MEL, "--init_aud", wav,
                     "--target_prompt", "a trumpet", "--sp", "2",
                     "--results_path", str(tmp_path)])


def test_sp0_is_the_no_op(tmp_path):
    """--sp 0 asks for nothing: no process group, no mesh."""
    wav = write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05)
    out = trun.main(_sa_argv(wav, tmp_path, "sp0") + ["--sp", "0"])
    assert _run_args(out)["mesh"] is None and not dist.is_initialized()


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2", "--device_num", "0"],
                                   ["--sp", "1", "--device_num", "1"]])
def test_more_ranks_than_cards_raises_before_any_rank_starts(tmp_path, monkeypatch, flags):
    """One card (the count patched): two ranks, or one rank past the last
    card, raise before any process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    wav = write_stereo_wav(str(tmp_path / "clip.wav"), seconds=0.05)
    with pytest.raises(ValueError, match="CUDA device"):
        trun.main(["--model_id", SA, "--init_aud", wav, "--target_prompt", "a cello",
                   "--results_path", str(tmp_path)] + flags)


def test_a_failing_rank_exits_non_zero(tmp_path):
    """Rank 1 raises while rank 0 waits on a collective: the launcher stops
    rank 0 and the run exits non-zero with rank 1's error named first."""
    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_parallel_helpers as r; "
            "from audioeditingcode_tpu_torch.parallel.launch import spawn; "
            "spawn(r.fail_on_rank, 2, 1, timeout=60)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    # the parent names the rank that failed first, with its traceback (rank
    # 0 fails after it, in the collective rank 1 left)
    assert "rank 1 of 2 failed first" in proc.stderr
    assert "rank 1 failed on purpose" in proc.stderr.split("failed first")[-1]
