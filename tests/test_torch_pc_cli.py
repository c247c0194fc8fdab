"""Unsupervised PC editing as a whole, on test/tiny-audioldm and
test/tiny-stable-audio: the port's extraction and application drivers
against the JAX package's on the same latent, the same params (bridged) and
the same draws (the JAX keys' draws passed to the port), extractions crossing
between the packages both ways, and the port's CLIs end to end on the CPU.

Tolerances (max abs error over max abs value unless said otherwise):
- the inversion's noise maps, the trajectory and the norm factors: 1e-4 (a
  chain of whole float32 forwards);
- the PCs: extraction runs at ``-c 0.1``, for the reason and the bounds of
  tests/test_torch_pc_drift.py: at the CLI's default c = 1e-3 the
  finite-difference probe of a tiny random model is float32 roundoff
  amplified 1000x, and two float32 implementations part after a few
  iterations. Held there: |cosine| >= 0.9999 with the same sign for each
  window step's PCs and snapshots, eigenvalues 5e-4 relative, in_norms 1e-4;
  in_corrs and the cross-timestep corrs, dot products of two unit vectors
  each that close (|Delta| <= 0.014), 3e-3 absolute (measured <= 1.1e-3);
- an application from the same extraction: 1e-3 on the final latents. The
  tiny AudioLDM's 6-step eta-1 DDIM chain lifts each step's ~6e-6 float32
  difference ~2.5x a step: JAX run step by step differs from the JAX
  driver's compiled scans by 3.2e-4 at the end, the port from the JAX
  driver by 2.1-2.4e-4 (measured; Stable Audio 1.4e-6).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.cli import pc_apply as jpa
from audioeditingcode_tpu.cli import pc_extract as jpe
from audioeditingcode_tpu.editing.pcdata import load_extraction as j_load
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.cli import pc_apply as tpa
from audioeditingcode_tpu_torch.cli import pc_extract as tpe
from audioeditingcode_tpu_torch.editing.pcdata import load_extraction as t_load
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

STEPS = 6
MODELS = {"audioldm": "test/tiny-audioldm", "stable_audio": "test/tiny-stable-audio"}
# (n_evs, patch): two PCs over the whole latent, one PC under a time-axis
# patch (two PCs under a patch take arbitrary signs in both packages:
# tests/test_torch_pc_drift.py::test_get_eigenvectors_patch_signs)
EXTRACTIONS = {"two_pcs": (2, None), "patch": (1, (4, 10))}
TRAJ_TOL = 1e-4
APPLY_TOL = 1e-3


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("aud")
    # 0.3 s: a (1, 4, 15, 32) mel latent, under the S >= 1024 attention path
    return {"audioldm": write_test_wav(str(d / "clip.wav"), seconds=0.3),
            "stable_audio": write_stereo_wav(str(d / "clip44.wav"))}


@pytest.fixture(scope="module")
def pipes():
    jal, jsa = jax_tiny_pipeline(STEPS), jax_tiny_stable_audio(STEPS)
    return {"audioldm": (jal, port_tiny_pipeline(STEPS, jal)),
            "stable_audio": (jsa, port_tiny_stable_audio(STEPS, jsa))}


def _argv(model, clip, n_evs, patch, extra=()):
    argv = ["--model_id", MODELS[model], "--init_aud", clip, "--num_diffusion_steps",
            str(STEPS), "--drift_start", "4", "--drift_end", "2", "--iters", "21",
            "--n_evs", str(n_evs), "-c", "0.1", "--seed", "3", "--wandb_disable",
            "--source_prompt", "a sine tone", *extra]
    return argv + (["--patch", str(patch[0]), str(patch[1])] if patch else [])


def _w0(model, jpipe, clip):
    x0, _, _ = jio.load_audio(clip, jpipe.mel_config, stft=model == "audioldm",
                              model_sr=jpipe.get_sr())
    if model == "audioldm":
        return jpipe.vae_encode(jnp.asarray(x0))
    return jpipe.vae_encode(jnp.asarray(x0), rng=jax.random.PRNGKey(11))


def _jax_draws(key, w0, window: int, n_evs: int):
    """The draws of the JAX driver from ``key``: the inversion's, then one
    v0 per window step."""
    key, r_inv = jax.random.split(key)
    inv = np.array(jax.random.normal(r_inv, (STEPS,) + w0.shape, dtype=w0.dtype))
    v0s = []
    for _ in range(window):
        key, r_eig = jax.random.split(key)
        v0s.append(torch.from_numpy(np.array(
            jax.random.normal(r_eig, (n_evs,) + w0.shape[1:], dtype=w0.dtype))))
    return torch.from_numpy(inv), v0s


@pytest.fixture(scope="module")
def extractions(pipes, clips, tmp_path_factory):
    """Each extraction through both drivers: (JAX npz, port npz)."""
    out = {}
    for model in MODELS:
        jpipe, tpipe = pipes[model]
        w0 = _w0(model, jpipe, clips[model])
        for name, (n_evs, patch) in EXTRACTIONS.items():
            d = tmp_path_factory.mktemp(f"{model}_{name}")
            argv = _argv(model, clips[model], n_evs, patch)
            jargs = jpe.parse_args(argv)
            key = jax.random.PRNGKey(5)
            jpath, _ = jpe.run_pc_extraction(jargs, jpipe, w0, key, 3.0, str(d), "jax", 3)
            targs = tpe.parse_args(argv + ["--device", "cpu"])
            inv, v0s = _jax_draws(key, w0, window=2, n_evs=n_evs)
            tw0 = torch.from_numpy(np.array(w0))
            tpath, txt = tpe.run_pc_extraction(targs, tpipe, tw0, None, 3.0, str(d), "port", 3,
                                               inv_noise=inv, v0s=v0s)
            out[model, name] = (jpath, tpath, txt)
    return out


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))


@pytest.mark.parametrize("name", list(EXTRACTIONS))
@pytest.mark.parametrize("model", list(MODELS))
def test_extraction_matches_jax(extractions, model, name):
    jpath, tpath, txt = extractions[model, name]
    j, t = np.load(jpath), np.load(tpath)
    assert sorted(j.files) == sorted(t.files)
    for f in ("eig_ts", "eig_its", "snapshot_iters"):
        np.testing.assert_array_equal(t[f], j[f])
    assert list(t["eig_its"]) == [2, 3]
    for f in ("latents", "xts", "norm_factors"):
        assert t[f].shape == j[f].shape and rel_err(t[f], j[f]) <= TRAJ_TOL, f
    assert rel_err(to_np(txt), j["xts"][-1]) <= TRAJ_TOL
    n_evs = EXTRACTIONS[name][0]
    assert t["eig_vecs"].shape[:2] == (2, n_evs)
    for w in range(2):
        for ev in range(n_evs):
            assert _cos(t["eig_vecs"][w, ev], j["eig_vecs"][w, ev]) >= 0.9999, (w, ev)
            assert _cos(t["interm_vecs"][w, 0, ev], j["interm_vecs"][w, 0, ev]) >= 0.9999
    for f in ("eig_vals", "interm_vals"):
        assert rel_err(t[f], j[f]) <= 5e-4, f
    assert rel_err(t["in_norms"], j["in_norms"]) <= 1e-4
    for f in ("in_corrs", "corrs"):
        assert t[f].shape == j[f].shape and np.abs(t[f] - j[f]).max() <= 3e-3, f
    jargs, targs = json.loads(str(j["args_json"])), json.loads(str(t["args_json"]))
    assert {k: targs[k] for k in jargs if k not in ("_mesh",)} == \
        {k: jargs[k] for k in jargs if k not in ("_mesh",)}


def _apply_argv(path, mode):
    argv = ["--extraction_path", path, "--drift_start", "4", "--drift_end", "2",
            "--amount", "2", "--seed", "1", "--wandb_disable"]
    return argv + {"per_ev": ["--evs", "1", "2"],
                   "combined": ["--evs", "1", "2", "--combine_evs"],
                   "fix_alpha": ["--fix_alpha", "0.3", "--fade_length", "2"]}[mode]


APPLY_MODES = {"per_ev": "two_pcs", "combined": "two_pcs", "fix_alpha": "patch"}


@pytest.mark.parametrize("mode", list(APPLY_MODES))
@pytest.mark.parametrize("model", list(MODELS))
def test_application_matches_jax(pipes, extractions, model, mode):
    """Both drivers apply the JAX extraction."""
    jpipe, tpipe = pipes[model]
    jpath = extractions[model, APPLY_MODES[mode]][0]
    argv = _apply_argv(jpath, mode)
    outs = []
    for cli, load, pipe in ((jpa, j_load, jpipe), (tpa, t_load, tpipe)):
        args = cli.parse_args(argv)
        loaded = load(jpath[: -len(".npz")])
        ex_args = loaded["args"]
        if args.fix_alpha is not None:
            args.fade_length = int(args.fade_length * loaded["latents"].shape[3] / 15)
        if cli is jpa:
            lat = jnp.asarray(loaded["latents"])
            xts = jnp.asarray(loaded["xts"]) if args.fix_alpha is not None else None
        else:
            lat = torch.from_numpy(loaded["latents"])
            xts = torch.from_numpy(loaded["xts"]) if args.fix_alpha is not None else None
        outs.append(np.asarray(to_np(cli.run_pc_application(
            args, pipe, ex_args, loaded["eigdata"], lat, xts, 3.0, float(ex_args.eta)))
            if cli is tpa else cli.run_pc_application(
                args, pipe, ex_args, loaded["eigdata"], lat, xts, 3.0, float(ex_args.eta))))
    want, got = outs
    rows = 1 if mode != "per_ev" else 2
    assert got.shape == want.shape and got.shape[0] == rows
    assert rel_err(got, want) <= APPLY_TOL
    # the drift moved the output away from the drift-free trajectory's end
    assert rel_err(got[:1], np.load(jpath)["xts"][-1]) > 1e-3


@pytest.mark.parametrize("model", list(MODELS))
def test_amount_zero_reproduces_the_trajectory(extractions, pipes, model):
    """A drift of 0 along one PC redoes each window step from its own x0
    prediction: the port's drift-free trajectory comes back up to float32
    roundoff of the two redone steps (measured <= 2e-6)."""
    tpath = extractions[model, "two_pcs"][1]
    args = tpa.parse_args(["--extraction_path", tpath, "--drift_start", "4",
                           "--drift_end", "2", "--amount", "0", "--evs", "1"])
    loaded = t_load(tpath[: -len(".npz")])
    got = tpa.run_pc_application(args, pipes[model][1], loaded["args"], loaded["eigdata"],
                                 torch.from_numpy(loaded["latents"]), None, 3.0, 1.0)
    assert rel_err(to_np(got), loaded["xts"][-1]) <= 1e-5


def _wavs(paths):
    from scipy.io import wavfile

    return [wavfile.read(p) for p in paths]


@pytest.mark.parametrize("model", list(MODELS))
def test_amount_zero_through_the_clis_gives_back_the_drift_free_wav(clips, model, tmp_path):
    """Extraction, then an application at amount 0, each through its CLI's
    main(): the application's wav is the extraction's drift-free wav, sample
    for sample within 2 LSB (the latents agree to float32 roundoff; int16
    rounding may flip the last bit; measured 0 and 1 LSB). The Stable Audio
    clip (10 ms) is shorter than the tiny model's 16 ms, so this holds the
    application to the duration conditioning and the decode crop that the
    extraction recorded: conditioned on the model's full length, the wav has
    64 samples instead of 40, and its first 40 differ by 184 LSB."""
    clip = (clips[model] if model == "audioldm"
            else write_stereo_wav(str(tmp_path / "short.wav"), seconds=0.01))
    ckpt = tpe.main(_argv(model, clip, 1, None, ["--device", "cpu", "--iters", "3",
                                                 "--results_path", str(tmp_path)]))
    outs = tpa.main(["--extraction_path", ckpt, "--drift_start", "4", "--drift_end", "2",
                     "--amount", "0", "--evs", "1", "--device", "cpu", "--seed", "0",
                     "--wandb_disable"])
    (sr_free, free), (sr, got) = _wavs([ckpt[: -len(".npz")] + ".wav", outs[0]])
    assert sr == sr_free and got.shape == free.shape
    if model == "stable_audio":
        assert free.shape == (40, 2)
    assert np.any(free) and np.abs(got.astype(np.int64) - free.astype(np.int64)).max() <= 2


@pytest.mark.parametrize("model", list(MODELS))
def test_extractions_cross_between_packages(extractions, model, tmp_path):
    """The JAX extraction drives the port's pc_apply, and the port's drives
    the JAX pc_apply."""
    jpath, tpath, _ = extractions[model, "two_pcs"]
    argv = ["--drift_start", "4", "--drift_end", "2", "--amount", "1.5", "--evs", "1", "2",
            "--seed", "0", "--wandb_disable"]
    t_outs = tpa.main(["--extraction_path", jpath, "--device", "cpu"] + argv)
    j_outs = jpa.main(["--extraction_path", tpath] + argv)
    for outs in (t_outs, j_outs):
        assert len(outs) == 2
        for sr, wav in _wavs(outs):
            assert sr == (16000 if model == "audioldm" else 4000) and wav.size and np.any(wav)


def test_bfloat16_extraction_is_overridden_to_float32(clips, tmp_path):
    with pytest.warns(UserWarning, match="unsound"):
        ckpt = tpe.main(_argv("stable_audio", clips["stable_audio"], 1, None,
                              ["--dtype", "bfloat16", "--device", "cpu", "--iters", "2",
                               "--results_path", str(tmp_path)]))
    loaded = t_load(ckpt[: -len(".npz")])
    assert loaded["args"].dtype == "float32"
    assert np.all(np.isfinite(loaded["eig_vecs"])) and np.all(loaded["eig_vals"] > 0)


@pytest.mark.parametrize("model", list(MODELS))
def test_ts_chunk_equals_one_step_chunks(clips, model, tmp_path):
    """A three-step window in chunks of 2 (a short tail chunk) equals chunks
    of 1: the same draws, the same numbers."""
    base = _argv(model, clips[model], 2, None, ["--device", "cpu", "--iters", "3",
                                                  "--drift_start", "5"])
    runs = [t_load(tpe.main(base + ["--results_path", str(tmp_path / c), "--ts_chunk", c])
                   [: -len(".npz")]) for c in ("1", "2")]
    assert list(runs[0]["eig_ts"]) == list(runs[1]["eig_ts"]) and len(runs[0]["eig_ts"]) == 3
    for f in ("eig_vecs", "eig_vals", "in_norms", "in_corrs", "corrs", "latents", "xts"):
        np.testing.assert_array_equal(runs[1][f], runs[0][f])


@pytest.mark.parametrize("argv,item", [
    (["--dp", "2"], "CUDA device"),
    (["--tp", "2"], "CUDA device"),
])
def test_extract_rejects_unported_flags(clips, tmp_path, monkeypatch, argv, item):
    """--dp/--tp are ported (tests/test_torch_parallel_cli.py runs them on
    gloo ranks): on the card, two ranks on a machine of one card (the count
    patched) raise before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=item):
        tpe.main(["--init_aud", clips["audioldm"], "--model_id", MODELS["audioldm"],
                  "--device", "cuda", "--results_path", str(tmp_path)] + argv)


def test_apply_rejects_unported_flags(extractions, tmp_path):
    """--weights_dir is ported: a directory without converted weights
    raises as the JAX registry does."""
    path = extractions["audioldm", "two_pcs"][1]
    with pytest.raises(FileNotFoundError, match="missing converted weights"):
        tpa.main(["--extraction_path", path, "--drift_start", "4", "--drift_end", "2",
                  "--amount", "1", "--weights_dir", str(tmp_path), "--device", "cpu"])


def test_clis_need_a_card_unless_told_cpu(clips, extractions, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.main(["--init_aud", clips["audioldm"], "--model_id", MODELS["audioldm"],
                  "--results_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpa.main(["--extraction_path", extractions["audioldm", "two_pcs"][1],
                  "--drift_start", "4", "--drift_end", "2", "--amount", "1"])


@pytest.mark.parametrize("matplotlib", [True, False], ids=["matplotlib", "no_matplotlib"])
@pytest.mark.parametrize("model", list(MODELS))
def test_clis_end_to_end_on_cpu(clips, model, matplotlib, tmp_path, monkeypatch, capsys):
    """Extraction then application through the CLIs, with the run record of
    each stage; without matplotlib the correlation plots are skipped."""
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    ckpt = tpe.main(_argv(model, clips[model], 2, None,
                          ["--device", "cpu", "--iters", "3",
                           "--results_path", str(tmp_path)]))
    save_path = os.path.dirname(ckpt)
    assert os.path.exists(os.path.join(save_path, "pc_corrs.png")) == matplotlib
    assert ("matplotlib not installed" in capsys.readouterr().out) != matplotlib
    with open(os.path.join(save_path, "run_args.json")) as f:
        rec = json.load(f)
    assert rec["stage_forwards"] == {"inversion": STEPS, "trajectory": STEPS,
                                     "power_iteration": 2 * 3}
    assert set(rec["stage_seconds"]) == {"inversion", "trajectory", "power_iteration"}
    assert rec["window_steps"] == 2 and rec["device"] == "cpu"
    outs = tpa.main(["--extraction_path", ckpt, "--drift_start", "4", "--drift_end", "2",
                     "--amount", "2", "--evs", "1", "2", "--device", "cpu", "--seed", "0"])
    assert len(outs) == 2 and all(os.path.exists(o) for o in outs)
    with open(os.path.join(os.path.dirname(outs[0]), "run_args.json")) as f:
        rec = json.load(f)
    assert rec["stage_forwards"] == {"trajectory": 2, "drift": STEPS - 2}
    for sr, wav in _wavs(outs):
        assert np.any(wav) and sr == (16000 if model == "audioldm" else 4000)
