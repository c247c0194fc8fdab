"""The port's demo-page builder (cli/demo_page.py, ``aetorch-demo-page``)
on the CPU: the four cases of tests/test_demo_page.py run on the port
(the one that runs real tiny-model edits is slow there and here), and the
page the port writes byte-equal to tools/build_demo_page.py's on the same
results trees: one lane, three lanes with MusicGen baselines, with and
without copied audio, with a banner, and empty."""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from audioeditingcode_tpu_torch.cli.demo_page import main, render, scan_results


def _fake_results(root):
    d = os.path.join(root, "tiny-audioldm", "clip",
                     "src_a_rock_song", "dec_a_metal_song__neg__")
    os.makedirs(d)
    t = np.zeros(1600, np.int16)
    wavfile.write(os.path.join(d, "orig.wav"), 16000, t)
    wavfile.write(os.path.join(d, "cfg_e_3_cfg_d_12_skip_2_123.wav"), 16000, t)
    wavfile.write(os.path.join(d, "cfg_e_3_cfg_d_15_skip_4_124.wav"), 16000, t)
    return d


def test_scan_and_render(tmp_path):
    _fake_results(str(tmp_path / "results"))
    rows = scan_results(str(tmp_path / "results"))
    assert len(rows) == 1
    r = rows[0]
    assert r.model == "tiny-audioldm"
    assert r.source_prompt == "a rock song"
    assert r.target_prompt == "a metal song"
    assert r.orig_wav and len(r.edited) == 2
    page = render(rows, str(tmp_path / "docs" / "supp.html"))
    assert page.count("<audio") == 3  # orig + 2 edits
    assert "a metal song" in page


def test_main_copies_audio(tmp_path):
    _fake_results(str(tmp_path / "results"))
    out = str(tmp_path / "docs" / "supp.html")
    audio_dir = str(tmp_path / "docs" / "resources" / "audio")
    main(["--results", str(tmp_path / "results"), "--out", out, "--copy-audio", audio_dir])
    assert os.path.exists(out)
    assert len(os.listdir(audio_dir)) == 3
    page = open(out).read()
    # copied files referenced relative to the page, no absolute paths
    assert "resources/audio/" in page and str(tmp_path) not in page


def test_empty_results_placeholder(tmp_path):
    (tmp_path / "results").mkdir()
    page = render(scan_results(str(tmp_path / "results")), str(tmp_path / "supp.html"))
    assert "No results yet" in page


def _lanes(root):
    """A three-lane results tree in the edit CLIs' layouts (two clips,
    ours with two cfg variants of one edit, ddim, sdedit's pmt_ layout)
    and both MusicGen baseline roots."""
    t = np.zeros(800, np.int16)
    for lane, clips in (("ours", ("clip0", "clip1")), ("ddim", ("clip0",))):
        for clip in clips:
            d = os.path.join(root, lane, "tiny-audioldm", clip, "src_a_sine_tone",
                             "dec_a_trumpet__neg__")
            os.makedirs(d, exist_ok=True)
            wavfile.write(os.path.join(d, "orig.wav"), 16000, t)
            for name in ("cfg_e_3_cfg_d_12_skip_2_1.wav", "cfg_e_3_cfg_d_15_skip_2_2.wav"):
                wavfile.write(os.path.join(d, name), 16000, t)
    d = os.path.join(root, "sdedit", "tiny-audioldm", "clip0", "pmt_a_trumpet__neg__")
    os.makedirs(d)
    wavfile.write(os.path.join(d, "s0_skip2_cfg12.wav"), 16000, t)
    for name in ("musicgen", "musicgen_large"):
        d = os.path.join(root, name, "clip0")
        os.makedirs(d)
        wavfile.write(os.path.join(d, "prompt_a trumpet.wav"), 16000, t)


@pytest.mark.parametrize("case", ["one_lane", "one_lane_copied", "three_lanes",
                                  "three_lanes_copied_banner", "empty"])
def test_page_is_byte_equal_to_the_jax_tool(tmp_path, case):
    from tools.build_demo_page import main as jax_main

    _lanes(str(tmp_path / "r"))
    r = str(tmp_path / "r")
    argv = ["--results", os.path.join(r, "ours")]
    if case == "empty":
        (tmp_path / "none").mkdir()
        argv = ["--results", str(tmp_path / "none")]
    if case.startswith("three_lanes"):
        argv += ["--sdedit", os.path.join(r, "sdedit"), "--ddim", os.path.join(r, "ddim"),
                 "--musicgen", os.path.join(r, "musicgen"),
                 "--musicgen_large", os.path.join(r, "musicgen_large")]
    if case.endswith("banner"):
        argv += ["--banner", "SYNTHETIC WEIGHTS — <rehearsal> & not results"]
    pages = {}
    for name, fn in (("jax", jax_main), ("port", main)):
        out = tmp_path / name / "supp.html"
        extra = ["--copy-audio", str(tmp_path / name / "audio")] if "copied" in case else []
        fn(argv + ["--out", str(out)] + extra)
        pages[name] = out.read_bytes()
        if extra:
            assert sorted(os.listdir(tmp_path / name / "audio"))
    assert pages["port"] == pages["jax"]
    if "copied" in case:
        assert (sorted(os.listdir(tmp_path / "port" / "audio"))
                == sorted(os.listdir(tmp_path / "jax" / "audio")))
    if case.startswith("three_lanes"):
        for col in ("ours", "sdedit", "ddim", "musicgen", "musicgen-large", "original"):
            assert f"<th>{col}</th>".encode() in pages["port"], col


@pytest.mark.slow
def test_comparison_page_all_method_lanes(tmp_path):
    """Real tiny-model runs of the port's CLIs for the ours/sdedit/ddim
    lanes and synthetic MusicGen trees: every method column of the
    supplementary page."""
    from audioeditingcode_tpu_torch.cli.run import main as run_main
    from audioeditingcode_tpu_torch.cli.sdedit import main as sdedit_main
    from audioeditingcode_tpu_torch.utils.audio_io import write_wav

    sr = 16000
    t = np.arange(sr // 4, dtype=np.float32) / sr
    clips = []
    for i, f0 in enumerate((330, 392)):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, (0.4 * np.sin(2 * np.pi * f0 * t))[None], sr)
        clips.append(p)
    common = ["--device", "cpu", "--model_id", "test/tiny-audioldm",
              "--num_diffusion_steps", "4", "--seed", "0", "--target_prompt", "a trumpet"]
    for p in clips:
        run_main(common + ["--init_aud", p, "--tstart", "3",
                           "--results_path", str(tmp_path / "ours")])
    run_main(common + ["--init_aud", clips[0], "--tstart", "4", "--mode", "ddim",
                       "--results_path", str(tmp_path / "ddim")])
    sdedit_main(common + ["--init_aud", clips[0], "--tstart", "3",
                          "--results_path", str(tmp_path / "sdedit")])
    for name in ("musicgen", "musicgen_large"):
        d = tmp_path / name / "clip0"
        d.mkdir(parents=True)
        wavfile.write(d / "prompt_a trumpet.wav", sr, np.zeros(1600, np.int16))
    out = str(tmp_path / "docs" / "supp.html")
    main(["--results", str(tmp_path / "ours"), "--sdedit", str(tmp_path / "sdedit"),
          "--ddim", str(tmp_path / "ddim"), "--musicgen", str(tmp_path / "musicgen"),
          "--musicgen_large", str(tmp_path / "musicgen_large"), "--out", out,
          "--copy-audio", str(tmp_path / "docs" / "resources" / "audio")])
    page = open(out).read()
    for col in ("ours", "sdedit", "ddim", "musicgen", "musicgen-large", "original"):
        assert f"<th>{col}</th>" in page, col
    assert "clip0" in page and "clip1" in page
    assert page.count("<audio") >= 7
    assert str(tmp_path) not in page
