"""The port's edit server (audioeditingcode_tpu_torch/serve.py) on the CPU:
``EditService.edit`` against the JAX ``EditService`` on bridged params with
the JAX draws passed in, the HTTP API (round trip, status codes, a response
bit-equal to the in-process edit, concurrent requests bit-equal to the same
requests sent alone) and the card requirement.

Tolerances (max abs error over max abs value): tiny AudioLDM's wav 2e-4
(a chain of whole float32 forwards through the tiny vocoder); tiny Stable
Audio's edited latent 3e-3, run from the JAX service's own latent, and the
port's Oobleck encode 5e-3 (tests/test_torch_stable_audio_e2e.py: the tiny
random Oobleck amplifies roundoff, so latents are compared, not wavs)."""

import base64
import io
import json
import os
import tempfile
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audioeditingcode_tpu.serve import EditService as JService
from audioeditingcode_tpu_torch import serve as tserve
from audioeditingcode_tpu_torch.utils.audio_io import load_audio
from test_torch_helpers import (
    bridge_stable_audio,
    jax_vae_noise,
    port_tiny_pipeline,
    record_stable_audio_decodes,
    rel_err,
)

STEPS = 5


def clip_bytes(sr=16000, seconds=0.5):
    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    buf = io.BytesIO()
    wave = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.02 * np.random.default_rng(0).standard_normal(
        t.shape)
    wavfile.write(buf, sr, (wave * 32767).astype(np.int16))
    return buf.getvalue()


@pytest.fixture(scope="module")
def services():
    """(JAX service, the port's on the CPU with the JAX service's params)."""
    jsvc = JService("test/tiny-audioldm", num_diffusion_steps=STEPS, dtype="float32")
    tsvc = tserve.EditService("test/tiny-audioldm", STEPS, dtype="float32", device="cpu")
    tsvc.pipe = port_tiny_pipeline(STEPS, jsvc.pipe)
    return jsvc, tsvc


def _latent_shape(pipe, wav: bytes, stft: bool):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "c.wav")
        with open(path, "wb") as f:
            f.write(wav)
        x0, _, _ = load_audio(path, pipe.mel_config, stft=stft, model_sr=pipe.get_sr())
    return tuple(pipe.vae_encode(torch.as_tensor(x0)).shape)


@pytest.mark.parametrize("source_prompt,tstart,cfg_tar,seed", [
    ("a sine tone", 3, 12.0, 0), ("", None, 5.0, 7)])
def test_edit_matches_jax(services, source_prompt, tstart, cfg_tar, seed):
    jsvc, tsvc = services
    wav = clip_bytes()
    want, jsr = jsvc.edit(wav, "a trumpet", source_prompt=source_prompt, tstart=tstart,
                          cfg_tar=cfg_tar, seed=seed)
    shape = _latent_shape(tsvc.pipe, wav, stft=True)
    noise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                                          (STEPS,) + shape)))
    got, sr = tsvc.edit(wav, "a trumpet", source_prompt=source_prompt, tstart=tstart,
                        cfg_tar=cfg_tar, seed=seed, noise=noise)
    assert sr == jsr == 16000 and got.shape == want.shape and got.ndim == 2
    assert rel_err(got, want) <= 2e-4
    assert tsvc.timings[-1]["unet_steps"] == STEPS + (tstart or STEPS // 2)


def test_stable_audio_edit_matches_jax_and_crops_each_request(monkeypatch):
    """Two clips of different durations through one service: each response
    is cropped to its request's duration, and the edit matches JAX. The
    edit runs from the JAX service's own latent: the tiny random Oobleck
    encoder alone puts the two packages' latents up to ~2.3e-3 apart on
    the longer clip (its own bound, 5e-3, is the e2e test's), which the
    edit would carry into the compared latent."""
    jsvc = JService("test/tiny-stable-audio", num_diffusion_steps=3, dtype="float32")
    tsvc = tserve.EditService("test/tiny-stable-audio", 3, dtype="float32", device="cpu")
    bridge_stable_audio(tsvc.pipe, jsvc.pipe)
    seen = record_stable_audio_decodes(monkeypatch)
    max_s = tsvc.pipe.audio_vae_length / tsvc.pipe.sample_rate
    port_encode = tsvc.pipe.vae_encode
    for frac in (0.3, 0.9):
        wav = clip_bytes(44100, frac * max_s)
        want, jsr = jsvc.edit(wav, "tiny", source_prompt="a tone", tstart=2, seed=0)
        rng, enc = jax.random.split(jax.random.PRNGKey(0))
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "c.wav")
            with open(path, "wb") as f:
                f.write(wav)
            x0, _, _ = load_audio(path, None, stft=False, model_sr=jsvc.pipe.get_sr())
        jw0 = np.asarray(jsvc.pipe.vae_encode(jax.numpy.asarray(x0), rng=enc))
        own = port_encode(torch.as_tensor(x0), jax_vae_noise(jsvc.pipe, 1, enc))
        assert rel_err(own.numpy(), jw0) <= 5e-3
        monkeypatch.setattr(tsvc.pipe, "vae_encode", lambda x, noise: torch.from_numpy(jw0))
        noise = torch.from_numpy(np.asarray(jax.random.normal(rng, (3,) + jw0.shape)))
        got, sr = tsvc.edit(wav, "tiny", source_prompt="a tone", tstart=2, seed=0, noise=noise)
        assert got.shape == want.shape and got.shape[0] == 2  # (C, T) stereo
        assert abs(got.shape[-1] - frac * max_s * sr) <= 2  # cropped to the request
        assert rel_err(seen["port"][-1], seen["jax"][-1]) <= 3e-3


@pytest.fixture(scope="module")
def server(services):
    _, tsvc = services
    srv = tserve.make_server(tsvc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", tsvc
    srv.shutdown()


def _post(url, payload, raw=None):
    req = urllib.request.Request(url + "/edit", data=raw if raw is not None
                                 else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _request(**kw):
    return {"audio_b64": base64.b64encode(clip_bytes()).decode(), "target_prompt": "a trumpet",
            **kw}


def test_http_round_trip_and_status_codes(server):
    url, tsvc = server
    with urllib.request.urlopen(url + "/healthz") as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "model": "test/tiny-audioldm", "backend": "cpu",
                      "steps": STEPS}
    code, body = _post(url, _request(tstart=3, source_prompt="a tone"))
    assert code == 200
    sr, data = wavfile.read(io.BytesIO(body))
    assert sr == 16000 and data.dtype == np.int16 and data.ndim == 1 and len(data) > 0
    assert _post(url, None, raw=b"{not json")[0] == 400
    assert _post(url, {"target_prompt": "x"})[0] == 400  # no audio_b64
    code, body = _post(url, _request(tstart=STEPS + 1))
    assert code == 400 and b"tstart must be in" in body
    assert _post(url, _request(tstart=0))[0] == 400
    try:
        urllib.request.urlopen(url + "/nothing")
        raise AssertionError("no 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_http_response_is_the_in_process_edit(server):
    url, tsvc = server
    code, body = _post(url, _request(tstart=2, cfg_tar=9.0, seed=4))
    audio, sr = tsvc.edit(clip_bytes(), "a trumpet", tstart=2, cfg_tar=9.0, seed=4)
    assert code == 200 and body == tserve._wav_bytes(audio, sr)


def test_concurrent_requests_equal_the_same_requests_alone(server):
    url, _ = server
    reqs = [_request(tstart=3, seed=1), _request(tstart=2, seed=2, target_prompt="a cello")]
    alone = [_post(url, r) for r in reqs]
    together = [None, None]

    def send(i):
        together[i] = _post(url, reqs[i])

    threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [c for c, _ in alone] == [200, 200]
    assert together == alone


def test_server_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--model_id", "test/tiny-audioldm", "--num_diffusion_steps", "3"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.EditService("test/tiny-audioldm", 3)
