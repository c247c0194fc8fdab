"""The port's signal frontend, timestep embedding and prompt conditioning
against the JAX package on the same wav and the same inputs.

Tolerances: the frontend's framed matmuls sum 1024 products in another
order. Where a bin is small (a pure tone's sidelobes) that float32 roundoff
is large relative to the bin, and the log amplifies it, so spectra are
compared in the linear domain, to 2e-5 of their peak; elementwise math to
~1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.models import embeddings as jemb
from audioeditingcode_tpu.models import text_encoders as jte
from audioeditingcode_tpu.ops import stft as jstft
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.models import embeddings as temb
from audioeditingcode_tpu_torch.models import text_encoders as tte
from audioeditingcode_tpu_torch.ops import stft as tstft
from audioeditingcode_tpu_torch.utils import audio_io as tio
from test_torch_helpers import to_np, write_test_wav


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    return write_test_wav(str(tmp_path_factory.mktemp("aud") / "clip.wav"), seconds=1.3)


def _assert_linear_close(got_log, want_log):
    got, want = np.exp(np.asarray(got_log, np.float64)), np.exp(np.asarray(want_log, np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.max(want))


def test_mel_spectrogram_matches():
    rng = np.random.default_rng(0)
    wave = (0.5 * rng.uniform(-1, 1, (2, 8000))).astype(np.float32)
    cfg = tstft.MelConfig()
    want = jstft.mel_spectrogram(jnp.asarray(wave), jstft.MelConfig())
    got = tstft.mel_spectrogram(torch.from_numpy(wave), cfg)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
    _assert_linear_close(to_np(got[0]), want[0])
    _assert_linear_close(to_np(got[1]), want[1])
    np.testing.assert_allclose(to_np(got[2]), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_allclose(to_np(tstft.stft_magnitude(torch.from_numpy(wave), cfg)),
                               np.asarray(jstft.stft_magnitude(jnp.asarray(wave),
                                                               jstft.MelConfig())),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(cfg.bases(), jstft.MelConfig().bases()):
        np.testing.assert_array_equal(a, b)


def test_load_audio_matches(wav):
    want, wsr, wdur = jio.load_audio(wav, jstft.MelConfig())
    got, gsr, gdur = tio.load_audio(wav, tstft.MelConfig())
    assert (gsr, gdur) == (wsr, wdur) and got.shape == want.shape == (1, 1, 133, 64)
    _assert_linear_close(got, want)
    fb_w, mag_w, wav_w = jio.wav_to_fbank(wav, 128)
    fb_g, mag_g, wav_g = tio.wav_to_fbank(wav, 128)
    np.testing.assert_array_equal(wav_g, wav_w)
    _assert_linear_close(fb_g, fb_w)
    _assert_linear_close(mag_g, mag_w)


def test_wav_helpers_match(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.3, 0.3, (1, 4410)).astype(np.float32)
    np.testing.assert_array_equal(tio.resample(x, 44100, 16000), jio.resample(x, 44100, 16000))
    np.testing.assert_array_equal(tio.normalize_wav(x), jio.normalize_wav(x))
    for n in (3000, 5000):
        np.testing.assert_array_equal(tio.pad_wav(x, n), jio.pad_wav(x, n))
    spec = rng.standard_normal((50, 65)).astype(np.float32)
    for n in (40, 60):
        np.testing.assert_array_equal(tio.pad_spec(spec, n), jio.pad_spec(spec, n))
    p = str(tmp_path / "w.wav")
    tio.write_wav(p, x, 16000)
    got, sr = tio.read_wav(p)
    want, _ = jio.read_wav(p)
    assert sr == 16000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,flip,shift", [(32, True, 0.0), (128, True, 0.0), (33, False, 1.0)])
def test_timestep_embedding(dim, flip, shift):
    t = np.array([1, 101, 501, 999], np.int32)
    want = jemb.get_timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip,
                                       downscale_freq_shift=shift)
    got = temb.get_timestep_embedding(torch.from_numpy(t), dim, flip_sin_to_cos=flip,
                                      downscale_freq_shift=shift)
    # sin/cos of arguments up to ~1e3: one f32 ulp of the argument is ~6e-5
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-4, rtol=0)


def test_null_text_encoder_bit_identical():
    prompts = ["a trumpet", "", "a cat meowing"]
    j = jte.NullTextEncoder(hidden_dim=12, seq_len=3, class_dim=32)(prompts)
    t = tte.NullTextEncoder(hidden_dim=12, seq_len=3, class_dim=32)(prompts)
    for f in ("hidden_states", "class_labels", "attention_mask"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    assert t.batch == 3 and t.hidden_states_1 is None


def test_concat_and_repeat_conds():
    enc = tte.NullTextEncoder(hidden_dim=4, seq_len=2, class_dim=6)
    jenc = jte.NullTextEncoder(hidden_dim=4, seq_len=2, class_dim=6)
    a, b = enc(["x"]), enc(["y", "z"])
    ja, jb = jenc(["x"]), jenc(["y", "z"])
    short = tte.TextCond(hidden_states=a.hidden_states[:, :1], class_labels=a.class_labels)
    jshort = jte.TextCond(hidden_states=ja.hidden_states[:, :1], class_labels=ja.class_labels)
    for (t1, t2), (j1, j2) in (((tte.repeat_cond(a, 2), b), (jte.repeat_cond(ja, 2), jb)),
                               ((short, b), (jshort, jb))):
        got, want = tte.concat_conds(t1, t2), jte.concat_conds(j1, j2)
        for f in ("hidden_states", "class_labels", "attention_mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    with pytest.raises(ValueError):
        tte.repeat_cond(b, 3)
