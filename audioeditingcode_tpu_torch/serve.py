"""HTTP edit server on PyTorch: one process, one pipeline on one card.

Counterpart of ``audioeditingcode_tpu/serve.py``, with the same HTTP API,
fields, defaults and status codes (stdlib only):

  GET  /healthz  -> {"status": "ok", "model": ..., "backend": ..., "steps": ...}
                    (``backend`` is the torch device type: "cuda" or "cpu")
  POST /edit     -> the edited WAV bytes
       JSON body: {"audio_b64": <base64 wav>, "target_prompt": str,
                   "source_prompt": str = "", "tstart": int = S//2,
                   "cfg_src": float = 3, "cfg_tar": float = 12, "seed": int = 0}
       a malformed body or a bad value -> 400, another failure -> 500.

Each request runs the ``--mode ours`` edit (edit-friendly inversion, then
the guided reverse pass from ``tstart``) under one lock per card, so
requests that arrive together run one after the other. The unconditional
encoding is made once at start-up. Stable Audio conditions each request on
its clip's duration and crops the decoded waveform to it. The port runs
eagerly, so it has no compiled-program cache: the JAX server's
``MAX_COMPILED``/``_compiled`` (one compiled edit per tstart) has no
counterpart here, and neither has its test of that cache. The draws come
from a ``torch.Generator`` seeded with the request's seed; ``edit`` also
takes them as arguments (``noise``, ``vae_noise``).

Run: ``python -m audioeditingcode_tpu_torch.serve --model_id ...
--num_diffusion_steps 50 --port 8080`` (``aetorch-serve``); on the CUDA
card ``--device_num`` unless ``--device cpu`` is given (a missing card is
an error).
"""

from __future__ import annotations

import base64
import collections
import io
import json
import os
import tempfile
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from .editing.invert import inversion_forward_process, inversion_reverse_process
from .models.registry import load_model, resolve_spec
from .utils.audio_io import load_audio
from .utils.device import resolve_device


class EditService:
    """The pipeline of one model on one device, answering edit requests
    one at a time. ``timings`` records the loop seconds and denoiser
    forwards of the last ``MAX_TIMINGS`` edits, in the order they ran."""

    MAX_TIMINGS = 64

    def __init__(self, model_id: str, num_diffusion_steps: int,
                 weights_dir: Optional[str] = None, dtype: str = "bfloat16",
                 device: str = "cuda", device_num: int = 0, seed: int = 0):
        self.device = resolve_device(device, device_num)
        self.model_id = model_id
        self.steps = num_diffusion_steps
        self.spec = resolve_spec(model_id)
        self.is_stable_audio = self.spec.family == "stable-audio"
        self.pipe = load_model(
            model_id, num_diffusion_steps, device=self.device, seed=seed,
            dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
            weights_dir=weights_dir)
        self._lock = threading.Lock()  # one edit at a time per card
        self._uncond = self.pipe.encode_text([""], negative=True)
        self.timings = collections.deque(maxlen=self.MAX_TIMINGS)

    @torch.no_grad()
    def edit(self, wav_bytes: bytes, target_prompt: str, source_prompt: str = "",
             tstart: Optional[int] = None, cfg_src: float = 3.0, cfg_tar: float = 12.0,
             seed: int = 0, noise: Union[torch.Tensor, torch.Generator, None] = None,
             vae_noise: Union[torch.Tensor, torch.Generator, None] = None):
        """One edit request; returns (wav float32 (1, T) or (C, T), sample
        rate). ``noise`` is the inversion's (S, *w0.shape) draw and
        ``vae_noise`` Stable Audio's latent-sample draw; each defaults to
        a generator seeded with ``seed`` on the device."""
        tstart = tstart if tstart is not None else self.steps // 2
        if not 1 <= int(tstart) <= self.steps:
            raise ValueError(f"tstart must be in [1, {self.steps}], got {tstart}")
        tstart = int(tstart)
        pipe, dev = self.pipe, self.device
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "request.wav")
            with open(path, "wb") as f:
                f.write(wav_bytes)
            x0_np, sr, duration = load_audio(path, pipe.mel_config, stft=not self.is_stable_audio,
                                             model_sr=pipe.get_sr(), device=dev)

        with self._lock:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            x0 = torch.as_tensor(x0_np, device=dev)
            if self.is_stable_audio:
                # the request's duration conditioning and decode crop
                max_s = pipe.audio_vae_length / pipe.sample_rate
                pipe.setup_duration(0.0, min(duration, max_s))
                w0 = pipe.vae_encode(x0, gen if vae_noise is None else vae_noise)
            else:
                w0 = pipe.vae_encode(x0)
            src = pipe.encode_text([source_prompt]) if source_prompt else None
            tgt = pipe.encode_text([target_prompt])
            shape = (1,) + tuple(w0.shape[1:])
            fwd = pipe.make_denoiser(self._uncond, src,
                                     torch.full(shape, float(cfg_src), device=dev))
            rev = pipe.make_denoiser(self._uncond, tgt,
                                     torch.full(shape, float(cfg_tar), device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, zs, xts, extras = inversion_forward_process(
                pipe.sched, fwd, w0, gen if noise is None else noise, return_extras=True)
            # the cosine solver's 2nd-order history carries over into the
            # reverse pass (None for DDIM)
            w_edit = inversion_reverse_process(
                pipe.sched, rev, xts, zs[:tstart],
                init_history=None if extras is None else extras[tstart - 1])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.timings.append({"edit_seconds": time.perf_counter() - t0,
                                 "unet_steps": self.steps + tstart})
            audio = pipe.decode_to_mel(pipe.vae_decode(w_edit)).float().cpu().numpy()
        if audio.ndim == 3:  # Stable Audio's stereo waveform (1, C, T)
            audio = audio[0]
        return audio, sr


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    a = np.clip(np.asarray(audio, np.float32), -1, 1)
    if a.ndim == 2:
        a = a.T
    wavfile.write(buf, sr, (a * 32767.0).astype(np.int16))
    return buf.getvalue()


def make_server(service: EditService, host: str = "127.0.0.1", port: int = 8080):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}")

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": service.model_id,
                                 "backend": service.device.type, "steps": service.steps})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/edit":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                wav = base64.b64decode(req["audio_b64"])
                params = dict(
                    target_prompt=req["target_prompt"],
                    source_prompt=req.get("source_prompt", ""),
                    tstart=req.get("tstart"),
                    cfg_src=float(req.get("cfg_src", 3.0)),
                    cfg_tar=float(req.get("cfg_tar", 12.0)),
                    seed=int(req.get("seed", 0)),
                )
            except Exception as e:  # malformed request -> 400
                self._json(400, {"error": str(e)})
                return
            try:
                audio, sr = service.edit(wav, **params)
            except (KeyError, ValueError, TypeError) as e:  # bad values
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # server-side fault (out of memory, a bug)
                self._json(500, {"error": str(e)})
                return
            try:
                body = _wav_bytes(audio, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception:
                pass  # the client hung up mid-response; headers already sent

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Audio-editing inference server")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("--model_id", default="cvssp/audioldm-s-full-v2")
    p.add_argument("--num_diffusion_steps", type=int, default=50)
    p.add_argument("--weights_dir", default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    service = EditService(args.model_id, args.num_diffusion_steps, args.weights_dir,
                          args.dtype, device=args.device, device_num=args.device_num)
    server = make_server(service, args.host, args.port)
    print(f"[serve] listening on {args.host}:{args.port} ({args.model_id})")
    server.serve_forever()


if __name__ == "__main__":
    main()
