"""The port's evals CLI against the JAX package's, and ``--profile_dir``.

Both CLIs run on the same tiny results tree with ``--allow_mel_fallback``
(no CLAP checkpoint is in the repository, so both take the weight-free mel
extractor): they write the same files, the CSVs and fad.json within 1e-5
(the two mel spectrograms differ by float32 roundoff,
tests/test_torch_evals.py). The resume file of either is read by the
other, which then recomputes nothing and writes the same tables. The port's
batch CLI writes a results tree that its evals CLI scores. ``--profile_dir``
on the tiny CPU edit writes a trace and leaves the wav unchanged."""

import json
import os
import shutil

import numpy as np
import pytest

from audioeditingcode_tpu.cli import evals_run as j_evals
from audioeditingcode_tpu_torch.cli import evals_run
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.evals.scores import read_csv
from test_torch_helpers import assert_tables_close, make_results_tree, write_test_wav


def _argv(tree, out, prev_pt):
    fad_gen = os.path.dirname(tree["wavs"][0])  # the three long ours edits
    return ["--ours_dirs", tree["ours"], "--ddim_dirs", tree["ddim"],
            "--sdedit_dirs", tree["sdedit"], "--musicgen_dirs", tree["musicgen"],
            "--inputs_orig", tree["inputs"], "--allow_mel_fallback", "--plots",
            "--fad_gen_dir", fad_gen, "--fad_ref_dirs", tree["inputs"], fad_gen,
            "--fad_gen_dirs", f"100={fad_gen}", f"120={tree['inputs']}",
            "--prev_pt", prev_pt, "--out_dir", out]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("evals_cli")
    tree = make_results_tree(root)
    outs = {}
    for name, main, extra in (("port", evals_run.main, ["--device", "cpu"]),
                              ("jax", j_evals.main, [])):
        out = str(root / f"out_{name}")
        with pytest.warns(UserWarning, match="MelStageExtractor"):
            main(_argv(tree, out, str(root / f"{name}.json")) + extra)
        outs[name] = out
    return tree, outs, root


def test_cli_writes_the_jax_cli_files_and_values(both):
    tree, outs, _ = both
    files = sorted(os.listdir(outs["port"]))
    assert files == sorted(os.listdir(outs["jax"]))
    assert {"scores_ours.csv", "scores_ddim.csv", "scores_sdedit.csv", "scores_musicgen.csv",
            "method_comparison.csv", "fad_by_skip.csv", "fad.json", "tradeoff_skip.png",
            "fad_scatter.png"} <= set(files)
    for f in files:
        if f.endswith(".csv"):
            assert_tables_close(os.path.join(outs["port"], f), os.path.join(outs["jax"], f))
    with open(os.path.join(outs["port"], "fad.json")) as f:
        got = json.load(f)
    with open(os.path.join(outs["jax"], "fad.json")) as f:
        want = json.load(f)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-5, atol=1e-5)
    # one row per scored wav, and the keys of the wavs in the trees
    rows = sum(len(read_csv(os.path.join(outs["port"], f"scores_{m}.csv")))
               for m in ("ours", "ddim", "sdedit", "musicgen"))
    assert rows == len(tree["wavs"])
    paths = sorted(r for m in ("ours", "ddim", "sdedit", "musicgen")
                   for r in read_csv(os.path.join(outs["port"], f"scores_{m}.csv")).column("path"))
    assert paths == tree["wavs"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_file_crosses_both_ways(both, writer):
    """The other CLI resumes from ``writer``'s --prev_pt: it recomputes
    nothing (an extractor that fails if called) and writes the writer's
    score tables, cell for cell."""
    tree, outs, root = both
    reader = "jax" if writer == "port" else "port"
    prev = str(root / f"{writer}.json")
    copy = str(root / f"cross_{writer}.json")
    shutil.copy(prev, copy)
    out = str(root / f"cross_{writer}_out")

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"resumed run recomputed a score ({name})")

    argv = ["--ours_dirs", tree["ours"], "--ddim_dirs", tree["ddim"], "--sdedit_dirs",
            tree["sdedit"], "--musicgen_dirs", tree["musicgen"], "--inputs_orig",
            tree["inputs"], "--prev_pt", copy, "--out_dir", out]
    mp = pytest.MonkeyPatch()
    try:
        if reader == "port":
            mp.setattr(evals_run, "default_extractor", lambda *a, **k: Untouchable())
            evals_run.main(argv + ["--device", "cpu"])
        else:
            import audioeditingcode_tpu.evals.features as jf

            mp.setattr(jf, "default_extractor", lambda *a, **k: Untouchable())
            j_evals.main(argv)
    finally:
        mp.undo()
    for m in ("ours", "ddim", "sdedit", "musicgen"):
        assert_tables_close(os.path.join(out, f"scores_{m}.csv"),
                            os.path.join(outs[writer], f"scores_{m}.csv"), tol=0.0)


def test_run_batch_results_are_scored(tmp_path):
    """The hand-off: the port's batch CLI edits a directory of clips, and
    the port's evals CLI scores the results tree it wrote, one row per
    edit, LPAPS against each clip's orig.wav."""
    from audioeditingcode_tpu_torch.cli import run_batch

    clips = tmp_path / "clips"
    clips.mkdir()
    for name, seconds in (("a", 0.5), ("b", 0.3)):
        write_test_wav(str(clips / f"{name}.wav"), seconds=seconds)
    run_batch.main(["--device", "cpu", "--model_id", "test/tiny-audioldm", "--init_aud",
                    str(clips), "--target_prompt", "a trumpet", "--num_diffusion_steps", "6",
                    "--tstart", "4", "--results_path", str(tmp_path / "res")])
    out = str(tmp_path / "scores")
    with pytest.warns(UserWarning, match="MelStageExtractor"):
        evals_run.main(["--device", "cpu", "--ours_dirs", str(tmp_path / "res" / "tiny-audioldm"),
                        "--allow_mel_fallback", "--out_dir", out])
    table = read_csv(os.path.join(out, "scores_ours.csv"))
    assert sorted(table.column("audio_input")) == ["a", "b"]
    assert all(float(x) >= 0 for x in table.column("lpaps"))
    assert table.column("skip") == ["2", "2"] and table.column("target_prompt") == [
        "a trumpet"] * 2


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evals_run.main(["--out_dir", str(tmp_path)])


def test_profile_dir_writes_a_trace_and_keeps_the_wav(tmp_path):
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.5)
    argv = ["--device", "cpu", "--model_id", "test/tiny-audioldm", "--num_diffusion_steps",
            "6", "--tstart", "4", "--seed", "0", "--init_aud", wav, "--target_prompt",
            "a trumpet"]
    plain = trun.main(argv + ["--results_path", str(tmp_path / "plain")])
    traced = trun.main(argv + ["--results_path", str(tmp_path / "traced"),
                               "--profile_dir", str(tmp_path / "prof")])
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    with open(plain, "rb") as a, open(traced, "rb") as b:
        assert a.read() == b.read()
