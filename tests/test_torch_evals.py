"""The port's eval tower against the JAX package's, on the CPU.

Windows, LPAPS, FAD and CLAP consistency are the JAX package's numpy code
copied: they are held to it at 1e-6 on the same inputs. The weight-free
mel extractor runs the port's torch mel spectrogram where the JAX one runs
its own, so its features agree to float32 roundoff: its log-mel stages as
energies to 2e-5 of the largest (as tests/test_torch_frontend.py holds the
mel spectrogram), its embeddings and the scores built on them to 1e-5. The CLAP feature extractor
is held to transformers' ClapFeatureExtractor (the function the JAX tower
calls) at 1e-5 absolute on the dB mel. The score tables are built from the
same records on both sides and compared cell by cell at 1e-5."""

import os

import numpy as np
import pytest

from audioeditingcode_tpu.evals import fad as j_fad
from audioeditingcode_tpu.evals import features as j_features
from audioeditingcode_tpu.evals import lpaps as j_lpaps
from audioeditingcode_tpu.evals import scores as j_scores
from audioeditingcode_tpu.evals import windows as j_windows
from audioeditingcode_tpu.evals.clap_consistency import CLAPTextConsistencyMetric as JClap
from audioeditingcode_tpu_torch.evals import fad, features, lpaps, scores, windows
from audioeditingcode_tpu_torch.evals.clap_consistency import CLAPTextConsistencyMetric
from audioeditingcode_tpu_torch.models.clap_processor import (ClapFeatureExtractor,
                                                               ClapProcessor)
from test_torch_helpers import assert_tables_close, make_results_tree

TOL = {"rtol": 1e-6, "atol": 1e-6}


@pytest.fixture(scope="module")
def exts():
    return features.MelStageExtractor(), j_features.MelStageExtractor()


def _tone(freq, seconds, sr=16000):
    t = np.arange(int(seconds * sr), dtype=np.float32) / sr
    return (0.4 * np.sin(2 * np.pi * freq * t))[None].astype(np.float32)


@pytest.mark.parametrize("seconds,overlap", [(3.0, 0.1), (25.0, 0.1), (25.0, 0.5)])
def test_windows_match_jax(seconds, overlap):
    aud = np.random.default_rng(0).standard_normal((2, int(seconds * 1000)))
    got = windows.split_to_overlapping_windows(aud, 1000, 10.0, overlap)
    want = j_windows.split_to_overlapping_windows(aud, 1000, 10.0, overlap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for method in ("mean", "median", "max", "min"):
        f = lambda w: float(w.sum())  # noqa: E731
        assert windows.windowed_score(f, [aud], [1000], None, overlap, method) == \
            j_windows.windowed_score(f, [aud], [1000], None, overlap, method)


def test_lpaps_distance_matches_jax():
    rng = np.random.default_rng(1)
    a = [rng.standard_normal((1, c, 8, 6)).astype(np.float32) for c in (4, 8)]
    b = [rng.standard_normal((1, c, 8, 6)).astype(np.float32) for c in (4, 8)]
    for axis in (1, -1):
        np.testing.assert_allclose(lpaps.lpaps_distance(a, b, axis),
                                   j_lpaps.lpaps_distance(a, b, axis), **TOL)
    assert lpaps.lpaps_distance(a, a) == 0.0


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 6))
    y = rng.standard_normal((30, 6)) * 1.3 + 0.2
    np.testing.assert_allclose(fad._sqrtm_psd(x.T @ x), j_fad._sqrtm_psd(x.T @ x), **TOL)
    np.testing.assert_allclose(fad.frechet_distance(x, y), j_fad.frechet_distance(x, y), **TOL)
    assert abs(fad.frechet_distance(x, x)) < 1e-6


def test_mel_extractor_matches_jax(exts):
    ext, jext = exts
    aud = _tone(440, 3.0)
    for g, w in zip(ext.stages(aud, 16000), jext.stages(aud, 16000)):
        assert g.shape == w.shape
        # log mels: compared as energies, to 2e-5 of the largest (the bins
        # far from the tone hold float32 roundoff, whose log differs more)
        g, w = np.exp(g.astype(np.float64)), np.exp(w.astype(np.float64))
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * w.max())
    np.testing.assert_allclose(ext.embed_audio(aud, 16000), jext.embed_audio(aud, 16000),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ext.embed_text(["a dog", "x"]), jext.embed_text(["a dog", "x"]))


def test_lpaps_and_consistency_windowed_match_jax(exts):
    ext, jext = exts
    a, b = _tone(440, 11.0), _tone(470, 11.0)
    got = lpaps.LPAPS(ext).windowed(a, b, 16000, 16000)
    want = j_lpaps.LPAPS(jext).windowed(a, b, 16000, 16000)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert lpaps.LPAPS(ext).windowed(a, a, 16000, 16000) == 0.0
    got = CLAPTextConsistencyMetric(ext).windowed(a, 16000, "a trumpet")
    want = JClap(jext).windowed(a, 16000, "a trumpet")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fad_scorer_embeddings_and_cache_match_jax(exts, tmp_path):
    ext, jext = exts
    tree = make_results_tree(tmp_path)
    d = os.path.dirname(tree["wavs"][0])
    got = fad.FADScorer(ext).embed_dir(d, use_cache=False)
    want = j_fad.FADScorer(jext).embed_dir(d, use_cache=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fad.FADScorer(ext).embed_dir(d)  # writes <wav>.emb.npy; JAX reads the port's cache
    cached = j_fad.FADScorer(jext).embed_dir(d)
    np.testing.assert_array_equal(cached, got)


@pytest.mark.parametrize("padding", ["repeatpad", "pad"])
@pytest.mark.parametrize("seconds", [3.3, 10.0])
def test_feature_extractor_matches_transformers(padding, seconds):
    from transformers import ClapFeatureExtractor as HF

    x = (np.random.default_rng(3).standard_normal(int(seconds * 48000)) * 0.3).astype(np.float32)
    want = HF(padding=padding)(x, sampling_rate=48000, return_tensors="np",
                               truncation="rand_trunc")["input_features"]
    got, longer = ClapFeatureExtractor(padding=padding)(x, 48000, truncation="rand_trunc")
    assert got.shape == want.shape == (1, 1, 1001, 64) and not longer
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_feature_extractor_long_clip_takes_the_offset_from_its_generator():
    from transformers import ClapFeatureExtractor as HF

    x = (np.random.default_rng(4).standard_normal(500000) * 0.3).astype(np.float32)
    np.random.seed(7)
    want = HF()(x, sampling_rate=48000, return_tensors="np",
                truncation="rand_trunc")["input_features"]
    np.random.seed(7)
    offset = np.random.randint(0, 500000 - 480000 + 1)

    class Fixed:
        def integers(self, lo, hi):
            assert (lo, hi) == (0, 20001)
            return offset

    got, longer = ClapFeatureExtractor()(x, 48000, truncation="rand_trunc", rng=Fixed())
    assert longer
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="rng"):
        ClapFeatureExtractor()(x, 48000, truncation="rand_trunc")


def test_fusion_and_a_missing_tokenizer_json_raise(tmp_path):
    x = np.zeros(48000, np.float32)
    with pytest.raises(ValueError, match="fusion"):
        ClapFeatureExtractor()(x, 48000)  # transformers' default config: fusion
    (tmp_path / "vocab.json").write_text("{}")
    (tmp_path / "merges.txt").write_text("")
    (tmp_path / "preprocessor_config.json").write_text("{}")
    with pytest.raises(ValueError, match="tokenizer.json"):
        ClapProcessor.from_dir(str(tmp_path))


def test_default_extractor_contract(tmp_path, monkeypatch):
    """A missing checkpoint is a hard error unless the mel fallback is asked
    for; an id names a directory under CHECKPOINT_ROOT; the torch backend
    without transformers raises an ImportError that names it."""
    monkeypatch.setattr(features, "CHECKPOINT_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="allow_mel_fallback"):
        features.default_extractor(device="cpu")
    with pytest.warns(UserWarning, match="MelStageExtractor"):
        ext = features.fad_extractor(allow_mel_fallback=True, device="cpu")
    assert isinstance(ext, features.MelStageExtractor)
    assert features.checkpoint_dir(str(tmp_path)) == str(tmp_path)
    (tmp_path / "laion" / "larger_clap_music").mkdir(parents=True)
    assert features.checkpoint_dir(features.FAD_CLAP_MUSIC) == str(
        tmp_path / "laion" / "larger_clap_music")
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        features.default_extractor(backend="torch", allow_mel_fallback=True)


def test_calc_and_combine_scores_match_jax(exts, tmp_path):
    """Four lanes (ours, ddim, sdedit, musicgen) of a tiny results tree:
    the records, the per-method CSVs and the comparison table agree with
    the JAX package's, which builds them with pandas."""
    ext, jext = exts
    tree = make_results_tree(tmp_path)
    kw = dict(ours_dirs=[tree["ours"]], ddim_dirs=[tree["ddim"]], sdedit_dirs=[tree["sdedit"]],
              musicgen_dirs=[tree["musicgen"]], inputs_orig=tree["inputs"], verbose=False)
    got = scores.calc_scores(ext, **kw)
    want = j_scores.calc_scores(jext, **kw)
    assert list(got.records) == list(want.records)
    assert len(got.records) == len(tree["wavs"])
    for k, r in got.records.items():
        w = want.records[k]
        assert (r.method, r.skip, r.tarcfg, r.srccfg, r.path) == (
            w.method, w.skip, w.tarcfg, w.srccfg, w.path)
        np.testing.assert_allclose([r.clap, r.lpaps], [w.clap, w.lpaps], rtol=1e-5, atol=1e-6)
    dfs, jdfs = scores.combine_scores(got), j_scores.combine_scores(want)
    assert list(dfs) == list(jdfs) == ["ddim", "musicgen", "ours", "sdedit"]
    for name in dfs:
        dfs[name].to_csv(str(tmp_path / f"port_{name}.csv"))
        jdfs[name].to_csv(str(tmp_path / f"jax_{name}.csv"), index=False)
        assert_tables_close(str(tmp_path / f"port_{name}.csv"), str(tmp_path / f"jax_{name}.csv"))
    scores.method_comparison_table(dfs).to_csv(str(tmp_path / "port_cmp.csv"))
    j_scores.method_comparison_table(jdfs).to_csv(str(tmp_path / "jax_cmp.csv"), index=False)
    assert_tables_close(str(tmp_path / "port_cmp.csv"), str(tmp_path / "jax_cmp.csv"))


@pytest.mark.parametrize("with_baseline", [False, True])
def test_tables_write_what_pandas_writes(tmp_path, with_baseline):
    """The same records give the same CSV text: column promotion (ints
    beside missing values become floats), empty cells, float repr, group
    order with missing keys last, sample std and counts."""
    import pandas as pd

    recs = [{"method": "ours", "audio_input": "a,b", "skip": s, "tarcfg": t, "srccfg": 3.0,
             "clap": 0.1 * s / 7 + t / 3, "lpaps": None if s == 120 and t == 8.0 else s / 1e3}
            for s in (100, 120) for t in (8.0, 12.0) for _ in range(2)]
    if with_baseline:
        recs.append({"method": "musicgen", "audio_input": "a", "skip": None, "tarcfg": None,
                     "srccfg": None, "clap": 0.45, "lpaps": 0.9})
    table = scores.Table.from_records(recs)
    frame = pd.DataFrame(recs)
    table.to_csv(str(tmp_path / "port.csv"))
    frame.to_csv(str(tmp_path / "jax.csv"), index=False)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    m = table.columns.index("method")
    lanes = {k: scores.Table(table.columns[:m] + table.columns[m + 1:],
                             [r[:m] + r[m + 1:] for r in table.rows if r[m] == k])
             for k in sorted(set(table.column("method")))}
    jlanes = {k: g.drop(columns=["method"]).reset_index(drop=True)
              for k, g in frame.groupby("method")}
    scores.method_comparison_table(lanes).to_csv(str(tmp_path / "port_cmp.csv"))
    j_scores.method_comparison_table(jlanes).to_csv(str(tmp_path / "jax_cmp.csv"), index=False)
    assert_tables_close(str(tmp_path / "port_cmp.csv"), str(tmp_path / "jax_cmp.csv"), 1e-12)
    fad_by_skip = {150: {"orig": 1.25, "fma": 4.0}, 100: {"orig": 2.0, "fma": 3.1}}
    scores.unsupervised_fad_table(fad_by_skip).to_csv(str(tmp_path / "port_fad.csv"))
    j_scores.unsupervised_fad_table(fad_by_skip).to_csv(str(tmp_path / "jax_fad.csv"),
                                                        index=False)
    assert (tmp_path / "port_fad.csv").read_text() == (tmp_path / "jax_fad.csv").read_text()


def test_score_state_resume_file_crosses_both_ways(tmp_path):
    rec = scores.ScoreRecord("ours", "clip", "a", "b", 100, 12.0, 3.0, 0.5, 0.25, "p.wav")
    st = scores.ScoreState({rec.key(): rec})
    st.save(str(tmp_path / "port.json"))
    jst = j_scores.ScoreState.load(str(tmp_path / "port.json"))
    assert {k: vars(r) for k, r in jst.records.items()} == {rec.key(): vars(rec)}
    jst.save(str(tmp_path / "jax.json"))
    back = scores.ScoreState.load(str(tmp_path / "jax.json"))
    assert {k: vars(r) for k, r in back.records.items()} == {rec.key(): vars(rec)}


def test_medley_prompts_match_jax():
    from audioeditingcode_tpu.data import medley as j_medley
    from audioeditingcode_tpu_torch.data import medley

    sources, targets = medley.load_medley_prompts()
    j_sources, j_targets = j_medley.load_medley_prompts()
    assert sources == j_sources
    assert [vars(t) for t in targets] == [vars(t) for t in j_targets]
    assert len(targets) == 696 and sum(map(len, sources.values())) == 107
    assert list(medley.iter_edit_pairs(sources, targets)) == list(
        j_medley.iter_edit_pairs(j_sources, j_targets))


def test_figures_are_written_and_need_matplotlib(tmp_path, monkeypatch):
    from audioeditingcode_tpu_torch.evals import figures

    ours = scores.Table.from_records([
        {"skip": s, "tarcfg": t, "srccfg": 3.0, "clap": 0.3 + 0.001 * s + 0.01 * t,
         "lpaps": 2.0 - 0.005 * s} for s in (100, 120, 140) for t in (8.0, 12.0)])
    mg = scores.Table.from_records([{"skip": None, "tarcfg": None, "srccfg": None,
                                     "clap": 0.45, "lpaps": 0.9}])
    fad_df = scores.unsupervised_fad_table({150: {"orig": 1.2, "fma": 4.0},
                                            100: {"orig": 2.0, "fma": 3.1}})
    paths = figures.save_eval_figures({"ours": ours, "musicgen": mg}, str(tmp_path),
                                      fad_df=fad_df)
    assert [os.path.basename(p) for p in paths] == [
        "tradeoff_skip.png", "tradeoff_tarcfg.png", "fad_scatter.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert figures._curve(ours, "skip", {"tarcfg": 12.0, "srccfg": 3.0})[0][0] == 100
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        figures.save_eval_figures({"ours": ours}, str(tmp_path))
