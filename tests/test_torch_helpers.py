"""Shared fixtures of the PyTorch-port parity tests, and the tests that pin
the port's boundaries (no JAX imports, no silent CPU run).

The parity tests hold ``audioeditingcode_tpu_torch`` against the JAX
package on the CPU: both get the same numpy inputs and the same params
(JAX ``load_model("test/tiny-audioldm")`` carried over by the bridge).
"""

import os
import re

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

# the suite runs in several worker processes at once; a few torch threads
# each keep them from oversubscribing the host's cores
torch.set_num_threads(min(2, os.cpu_count() or 1))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "audioeditingcode_tpu_torch")


def jax_tiny_pipeline(steps: int, model_id: str = "test/tiny-audioldm"):
    from audioeditingcode_tpu.models.registry import load_model

    return load_model(model_id, steps)


def port_tiny_pipeline(steps: int, jpipe=None, model_id: str = "test/tiny-audioldm"):
    """The port's tiny mel-family pipeline on the CPU, with the JAX
    pipeline's params."""
    from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
    from audioeditingcode_tpu_torch.models.registry import load_model

    jpipe = jpipe or jax_tiny_pipeline(steps, model_id)
    pipe = load_model(model_id, steps, device="cpu")
    for mod, params in ((pipe.unet, jpipe.unet_params), (pipe.vae, jpipe.vae_params),
                        (pipe.vocoder, jpipe.vocoder_params)):
        mod.load_state_dict(flax_to_torch_state_dict(flatten_dict(params), mod))
    return pipe


def jax_tiny_stable_audio(steps: int):
    from audioeditingcode_tpu.models.registry import load_model

    return load_model("test/tiny-stable-audio", steps)


def bridge_stable_audio(pipe, jpipe):
    """Load the JAX Stable Audio pipeline's params into the port's one."""
    from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict

    for mod, params in ((pipe.dit, jpipe.dit_params), (pipe.vae, jpipe.vae_params),
                        (pipe.projection, jpipe.projection_params)):
        mod.load_state_dict(flax_to_torch_state_dict(flatten_dict(params), mod))
    pipe.setup_duration()
    return pipe


def port_tiny_stable_audio(steps: int, jpipe=None, dtype=torch.float32):
    """The port's tiny Stable Audio pipeline on the CPU, with the JAX
    pipeline's params."""
    from audioeditingcode_tpu_torch.models.registry import load_model

    jpipe = jpipe or jax_tiny_stable_audio(steps)
    return bridge_stable_audio(load_model("test/tiny-stable-audio", steps, device="cpu",
                                          dtype=dtype), jpipe)


def bridged_loader(model_id: str, steps: int, dtype=torch.float32):
    """A stand-in for a port CLI's ``load_model``: the port pipeline with the
    JAX CLI's weights (the JAX CLIs load with seed 0) carried over by the
    bridge, built once."""
    if model_id == "test/tiny-stable-audio":
        pipe = port_tiny_stable_audio(steps, dtype=dtype)
    else:
        pipe = port_tiny_pipeline(steps, jax_tiny_pipeline(steps, model_id), model_id)

    def load(mid, num_steps, device="cpu", dtype=torch.float32, seed=0, weights_dir=None):
        assert (mid, num_steps, str(device)) == (model_id, steps, "cpu")
        return pipe

    return load


def jax_vae_noise(jpipe, n: int, rng):
    """The JAX Stable Audio ``vae_encode``'s latent-sample draw for n rows,
    in the port's (n, C, L) layout."""
    import jax

    L, C = jpipe.sample_size, jpipe.vae.config.decoder_input_channels
    return torch.from_numpy(
        np.asarray(jax.random.normal(rng, (n, L, C))).transpose(0, 2, 1).copy())


def jax_row_noise(rng, steps: int, w0) -> torch.Tensor:
    """The inversion draws of the JAX CLIs' ``jax.vmap`` over N windows or
    clips: row i from key i of ``jax.random.split(rng, N)``, as the port's
    (S, N, ...) tensor."""
    import jax

    keys = jax.random.split(rng, w0.shape[0])
    per = [np.asarray(jax.random.normal(k, (steps, 1) + tuple(w0.shape[1:]))) for k in keys]
    return torch.from_numpy(np.concatenate(per, axis=1))


def record_stable_audio_decodes(monkeypatch) -> dict:
    """Record every latent the two Stable Audio pipelines decode, in order
    ("jax", "port"; the JAX one from inside jit by a debug callback).

    The CLI tests on test/tiny-stable-audio compare these latents, not the
    wavs: the tiny random Oobleck decoder saturates on them (peaks of
    ~30-140, clipped to 1 in the wav) and lifts a float32 difference of the
    latent ~4000x, so that two latents 1e-5 apart decode 1e-2 apart and
    the clipped wavs part by thousands of LSB."""
    import jax

    from audioeditingcode_tpu.models.pipeline1d import StableAudioPipeline as JPipe
    from audioeditingcode_tpu_torch.models.pipeline1d import StableAudioPipeline as TPipe

    seen = {"jax": [], "port": []}
    real_j, real_t = JPipe.vae_decode, TPipe.vae_decode

    def jdec(self, z):
        jax.debug.callback(lambda v: seen["jax"].append(np.asarray(v)), z)
        return real_j(self, z)

    def tdec(self, z):
        seen["port"].append(to_np(z))
        return real_t(self, z)

    monkeypatch.setattr(JPipe, "vae_decode", jdec)
    monkeypatch.setattr(TPipe, "vae_decode", tdec)
    return seen


def results_layout(out: str, root) -> tuple:
    """An output's directory under ``root`` and the names beside it, with
    the timestamps dropped."""
    d = os.path.dirname(out)
    return (os.path.relpath(d, root),
            sorted(re.sub(r"_\d{6,}", "", f) for f in os.listdir(d)))


def wav_close(got_path: str, want_path: str, rel: float) -> float:
    """Two int16 wavs of one rate and shape agree within one LSB beside
    ``rel`` of the larger's peak; returns the max difference in LSB."""
    from scipy.io import wavfile

    (sa, a), (sb, b) = wavfile.read(got_path), wavfile.read(want_path)
    assert sa == sb and a.shape == b.shape and np.any(b), (sa, sb, a.shape, b.shape)
    a, b = a.astype(np.float64), b.astype(np.float64)
    diff = float(np.abs(a - b).max())
    assert diff <= 1 + rel * np.abs(b).max(), diff
    return diff


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest at 10 mantissa
    bits, ties away from zero, on the int32 view."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """The float32 kernels' split into TF32 parts (csrc/tf32.cuh::split): hi
    by Veltkamp's split at 11 significant bits, lo = x - hi with its low 13
    bits masked off."""
    c = x * 8193.0
    hi = c + (x - c)
    return hi, ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)


def write_test_wav(path: str, seconds: float = 1.0, sr: int = 16000) -> str:
    """Two tones over a seeded noise floor. The floor keeps every mel bin
    well above the log clamp, where float32 roundoff of the framed matmuls
    would be amplified by the log."""
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    wave = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
    wave += 0.02 * np.random.default_rng(0).standard_normal(t.shape)
    wavfile.write(path, sr, (wave * 32767).astype(np.int16))
    return path


def write_stereo_wav(path: str, seconds: float = 1.0, sr: int = 4000) -> str:
    """A stereo clip: a different tone in each channel."""
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    left = 0.4 * np.sin(2 * np.pi * 330 * t)
    right = 0.3 * np.sin(2 * np.pi * 520 * t + 0.5)
    wavfile.write(path, sr, (np.stack([left, right], axis=1) * 32767).astype(np.int16))
    return path


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|audioeditingcode_tpu)\b", re.M)


@pytest.mark.parametrize("root", ["audioeditingcode_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax(root):
    """The port and its chip script import neither jax, flax nor the JAX
    package (``\b`` keeps ``audioeditingcode_tpu_torch`` itself allowed)."""
    path = os.path.join(REPO, root)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            src = fh.read()
        bad = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
        assert not bad, f"{f}: {bad}"


def test_cuda_device_missing_raises(monkeypatch):
    from audioeditingcode_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_device_time_needs_a_card(monkeypatch):
    """The device-only timer raises without a card, before it calls fn."""
    from audioeditingcode_tpu_torch.utils.timing import device_ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        device_ms(lambda: calls.append(1), reps=2)
    assert calls == []


def test_device_time_takes_a_profile_again_when_it_has_no_device_time(monkeypatch):
    """A profile with no device activity is taken again; a time comes from
    the first profile that has some, and none from profiles that all lack
    it."""
    import types

    import torch.profiler
    from torch.autograd import DeviceType

    from audioeditingcode_tpu_torch.utils.timing import device_ms

    delivered = iter([[], [], [("k", 300.0)], [], [], []])

    class Profile:
        def __init__(self, activities):
            self.events = next(delivered)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [types.SimpleNamespace(device_type=DeviceType.CUDA,
                                          self_device_time_total=us)
                    for _, us in self.events]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    calls = []
    assert device_ms(lambda: calls.append(1), reps=3, warmup=1) == pytest.approx(0.1)
    assert len(calls) == 1 + 3 * 3  # warmup, then three profiles of 3 reps
    with pytest.raises(RuntimeError, match="no device time in 3 profiles"):
        device_ms(lambda: None, reps=2)


def test_cpu_tensors_take_the_plain_version():
    """On a CPU tensor the dispatcher computes the plain version and never
    reaches the kernel wrapper (whose count stays put)."""
    from audioeditingcode_tpu_torch.ops import flash_attention as fa

    before = fa.flash_attention_cuda.launches
    q = torch.randn(1, 1024, 2, 16)
    out = fa.fused_attention(q, q, q)
    torch.testing.assert_close(out, fa.attention_reference(q, q, q), rtol=0, atol=0)
    assert fa.flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q)


TINY_CLAP_AUDIO = dict(spec_size=64, num_mel_bins=16, patch_size=4, patch_stride=[4, 4],
                       window_size=4, depths=[2, 2], num_attention_heads=[2, 4],
                       patch_embeds_hidden_size=8, hidden_size=16)


def make_clap_model_dir(d: str, projection_dim: int, hidden: int = 24, max_len: int = 16) -> None:
    """A full transformers ClapModel (text and audio towers), as AudioLDM2's
    text_encoder/ holds one, with the text tower of
    test_convert_integration.make_clap_text_model_dir."""
    from transformers import ClapAudioConfig, ClapConfig, ClapModel, ClapTextConfig

    tc = ClapTextConfig(vocab_size=120, hidden_size=hidden, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=2 * hidden,
                        max_position_embeddings=max_len + 4, projection_dim=projection_dim)
    ac = ClapAudioConfig(**TINY_CLAP_AUDIO, projection_dim=projection_dim)
    ClapModel(ClapConfig(text_config=tc.to_dict(), audio_config=ac.to_dict(),
                         projection_dim=projection_dim)).save_pretrained(d)


def checkpoint_state_dict(model_id: str, part: str, params, transform,
                          weight_norm: bool = False) -> dict:
    """The JAX ``params`` of a part (its ``params`` subtree), each leaf but
    fixed ``weight`` buffers through ``transform``, as the state dict of
    the diffusers / transformers checkpoint: the port module's names and
    layouts (``bridge.flax_to_torch_state_dict``), transformers' vocoder
    ``upsampler.N`` and diffusers' VQ ``quantize.embedding.weight``.
    ``weight_norm`` stores each 3-D conv weight as a ``weight_g`` /
    ``weight_v`` pair (the Oobleck VAE's layout at rest)."""
    from audioeditingcode_tpu_torch.models import convert as cv
    from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS as PORT_SPECS

    flat = {k: np.asarray(v, np.float32) if k[-1] == "weight"
            else transform(np.asarray(v, np.float32)) for k, v in flatten_dict(params).items()}
    with torch.device("meta"):
        module = cv.part_factory(PORT_SPECS[model_id], part)()
    sd = {}
    for k, v in flax_to_torch_state_dict(flat, module).items():
        k = re.sub(r"^ups\.", "upsampler.", k)
        k = "quantize.embedding.weight" if k == "codebook" else k
        if weight_norm and k.endswith(".weight") and v.dim() == 3:
            sd[k + "_g"] = torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True).numpy()
            k += "_v"
        sd[k] = v.numpy()
    return sd


def build_source_checkpoint(model_id: str, src: str, clap_model: bool = False,
                            weight_norm: bool = False) -> str:
    """A complete fake checkpoint of a tiny model in the diffusers pipeline
    layout, with the names of the real ones, built from the JAX tiny
    model's params and the helpers of tests/test_convert_integration.py;
    returns ``src``. The text towers are real transformers models with
    offline tokenizers; ``clap_model`` makes text_encoder/ a full ClapModel
    (AudioLDM2's layout) instead of a ClapTextModelWithProjection;
    ``weight_norm`` stores the Oobleck VAE's convs weight-normed."""
    import test_convert_integration as tci
    from audioeditingcode_tpu.models.configs import MODEL_SPECS

    spec = MODEL_SPECS[model_id]
    torch.manual_seed(0)  # the transformers towers' init
    if model_id == "test/tiny-stable-audio":
        from test_convert_tool import make_dit_state_dict

        jpipe = jax_tiny_stable_audio(3)
        dit = {}
        for k, v in make_dit_state_dict(spec.dit, np.random.RandomState(5)).items():
            if v.ndim >= 2:  # N(0, 1) -> N(0, 1/fan_in), as the seeded init
                v = v / np.sqrt(np.prod(v.shape[1:]))
            elif k.endswith("norm1.weight") or k.endswith("norm2.weight") or \
                    k.endswith("norm3.weight"):
                v = 1.0 + 0.01 * v
            elif k != "time_proj.weight":
                v = 0.01 * v
            dit[k] = v.astype(np.float32)
        tci.save_safetensors(dit, os.path.join(src, "transformer"))
        tci.save_safetensors(checkpoint_state_dict(
            model_id, "oobleck", jpipe.vae_params["params"], lambda x: x * 0.5, weight_norm),
            os.path.join(src, "vae"))
        pc, r = spec.projection, np.random.RandomState(6)
        proj = {"text_projection.0.weight": r.randn(pc.conditioning_dim, pc.text_encoder_dim),
                "text_projection.2.weight": r.randn(pc.conditioning_dim, pc.conditioning_dim)}
        for side in ("start", "end"):
            key = f"{side}_number_conditioner.time_positional_embedding"
            proj |= {f"{key}.0.weights": r.randn(pc.internal_dim // 2),
                     f"{key}.1.weight": r.randn(pc.conditioning_dim, pc.internal_dim + 1),
                     f"{key}.1.bias": r.randn(pc.conditioning_dim)}
        tci.save_safetensors({k: (0.2 * v).astype(np.float32) for k, v in proj.items()},
                             os.path.join(src, "projection_model"))
        tci.make_t5_model_dir(os.path.join(src, "text_encoder"), d_model=pc.text_encoder_dim)
        tci.make_t5_tokenizer_dir(os.path.join(src, "tokenizer"))
        return src
    # mildly perturbed seed-0 params: the test's usual 1.5x + 0.01 makes
    # the tiny vocoder amplify float32 roundoff ~100x into the wav
    jpipe = jax_tiny_pipeline(4, model_id)
    perturb = lambda x: x * 1.01 + 1e-3  # noqa: E731
    for part in ("unet", "vqvae" if spec.family == "celebahq" else "vae", "vocoder"):
        params = getattr(jpipe, ("vae" if part == "vqvae" else part) + "_params")
        if params is not None:
            tci.save_safetensors(checkpoint_state_dict(model_id, part, params["params"],
                                                       perturb), os.path.join(src, part))
    if spec.family == "audioldm":
        tci.make_clap_text_model_dir(os.path.join(src, "text_encoder"), projection_dim=32)
        tci.make_roberta_tokenizer_dir(os.path.join(src, "tokenizer"))
    elif spec.family == "tango":
        tci.make_t5_model_dir(os.path.join(src, "text_encoder"), d_model=32)
        tci.make_t5_tokenizer_dir(os.path.join(src, "tokenizer"))
    elif spec.family == "stable-diffusion":
        from transformers import CLIPTextConfig, CLIPTextModel

        CLIPTextModel(CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=2, vocab_size=200,
                                     max_position_embeddings=12)).save_pretrained(
            os.path.join(src, "text_encoder"), safe_serialization=False)
        tci.make_clip_tokenizer_dir(os.path.join(src, "tokenizer"))
    elif spec.family == "audioldm2":
        from transformers import GPT2Config as TorchGPT2Config
        from transformers import GPT2Model as TorchGPT2

        lm = spec.projection_lm
        (make_clap_model_dir if clap_model else tci.make_clap_text_model_dir)(
            os.path.join(src, "text_encoder"), projection_dim=lm.text_encoder_dim)
        tci.make_roberta_tokenizer_dir(os.path.join(src, "tokenizer"))
        tci.make_t5_model_dir(os.path.join(src, "text_encoder_2"), d_model=lm.text_encoder_1_dim)
        tci.make_t5_tokenizer_dir(os.path.join(src, "tokenizer_2"))
        g = spec.gpt2
        torch.manual_seed(0)
        gpt2 = TorchGPT2(TorchGPT2Config(n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head,
                                         n_positions=g.n_positions, vocab_size=50))
        tci.save_safetensors({k: v.detach().numpy() for k, v in gpt2.state_dict().items()},
                             os.path.join(src, "language_model"))
        D, r = lm.langauge_model_dim, np.random.RandomState(2)
        proj = {"projection.weight": r.randn(D, lm.text_encoder_dim),
                "projection.bias": r.randn(D),
                "projection_1.weight": r.randn(D, lm.text_encoder_1_dim),
                "projection_1.bias": r.randn(D)}
        proj |= {k: r.randn(D) for k in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1")}
        tci.save_safetensors({k: (0.2 * v).astype(np.float32) for k, v in proj.items()},
                             os.path.join(src, "projection_model"))
    return src


def build_converted_checkpoint(model_id: str, root: str) -> str:
    """``build_source_checkpoint`` under ``<root>/src``, converted by the JAX
    converter (tools/convert_checkpoint.py::convert) into ``<root>/out``;
    returns the weights_dir."""
    from tools.convert_checkpoint import convert

    src, out = os.path.join(root, "src"), os.path.join(root, "out")
    convert(model_id, build_source_checkpoint(model_id, src), out)
    return out


CKPT_STEPS = 6  # the diffusion steps of the converted_pipelines fixture


@pytest.fixture(scope="module")
def converted_dirs(tmp_path_factory):
    """model id -> the weights_dir of a converted tiny checkpoint, each
    built once per test module."""
    cache = {}

    def get(model_id):
        if model_id not in cache:
            cache[model_id] = build_converted_checkpoint(
                model_id, str(tmp_path_factory.mktemp(model_id.split("/")[1])))
        return cache[model_id]
    return get


@pytest.fixture(scope="module")
def converted_pipelines(converted_dirs):
    """model id -> (weights_dir, JAX pipeline, port pipeline) at CKPT_STEPS
    steps, each loaded once per test module."""
    from audioeditingcode_tpu.models.registry import load_model as jload
    from audioeditingcode_tpu_torch.models.registry import load_model

    cache = {}

    def get(model_id):
        if model_id not in cache:
            wd = converted_dirs(model_id)
            cache[model_id] = (wd, jload(model_id, CKPT_STEPS, weights_dir=wd),
                               load_model(model_id, CKPT_STEPS, device="cpu", weights_dir=wd))
        return cache[model_id]
    return get


def _tone_wav(path, freq: float, seconds: float, sr: int = 16000, amp: float = 0.4) -> None:
    from scipy.io import wavfile

    t = np.arange(int(seconds * sr), dtype=np.float64) / sr
    wave = amp * np.sin(2 * np.pi * freq * t) + 0.05 * np.sin(2 * np.pi * 3.1 * freq * t)
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    wavfile.write(str(path), sr, (wave * 32767).astype(np.int16))


def make_results_tree(root) -> dict:
    """A tiny results tree of the four eval lanes in the CLIs' layouts, with
    the originals: {lane: root dir} plus "inputs" (original input wavs,
    for the MusicGen lane) and "wavs" (every generation scored). One ours
    clip runs past 10 s, so it is scored in two windows."""
    root = str(root)
    ours = os.path.join(root, "ours", "model")
    a = os.path.join(ours, "clip", "src_a_piano", "dec_a_trumpet__neg__")
    b = os.path.join(ours, "clip2", "src_", "dec_a_violin__neg__")
    ddim = os.path.join(root, "ddim", "model", "clip", "src_a_piano",
                        "dec_a_trumpet__neg__")
    sd = os.path.join(root, "sdedit", "model", "clip", "pmt_a_trumpet__neg__")
    mg = os.path.join(root, "musicgen", "clip")
    wavs = {
        os.path.join(a, "cfg_e_3.0_cfg_d_12.0_skip_100_123.wav"): (440, 11.0),
        os.path.join(a, "cfg_e_3.0_cfg_d_8.0_skip_120_124.wav"): (452, 11.0),
        os.path.join(a, "cfg_e_1.0_cfg_d_12.0_skip_100_125.wav"): (470, 11.0),
        os.path.join(b, "cfg_e_3.0_cfg_d_12.0_skip_100_126.wav"): (300, 1.5),
        os.path.join(ddim, "cfg_e_3.0_cfg_d_12.0_200timesteps_127.wav"): (460, 2.0),
        os.path.join(sd, "s0_skip100_cfg12.0.wav"): (430, 2.0),
        os.path.join(sd, "s0_skip120_cfg8.0.wav"): (425, 2.0),
        os.path.join(mg, "prompt_a trumpet.wav"): (445, 2.0),
    }
    for path, (freq, seconds) in wavs.items():
        _tone_wav(path, freq, seconds)
    for d, seconds in ((a, 11.0), (b, 1.5), (ddim, 2.0), (sd, 2.0)):
        _tone_wav(os.path.join(d, "orig.wav"), 441, seconds)
    inputs = os.path.join(root, "inputs")
    _tone_wav(os.path.join(inputs, "clip.wav"), 441, 2.0)
    return {"ours": ours, "ddim": os.path.dirname(os.path.dirname(os.path.dirname(ddim))),
            "sdedit": os.path.dirname(os.path.dirname(sd)),
            "musicgen": os.path.dirname(mg), "inputs": inputs, "wavs": sorted(wavs)}


def assert_tables_close(got_path: str, want_path: str, tol: float = 1e-5) -> None:
    """Two CSVs with the same header and rows, numbers within ``tol``
    (relative and absolute) and every other cell equal."""
    import csv

    with open(got_path, newline="") as f:
        got = list(csv.reader(f))
    with open(want_path, newline="") as f:
        want = list(csv.reader(f))
    assert got[0] == want[0], (got[0], want[0])
    assert len(got) == len(want), (len(got), len(want))
    for rg, rw in zip(got[1:], want[1:]):
        for cg, cw, col in zip(rg, rw, got[0]):
            try:
                fg, fw = float(cg), float(cw)
            except ValueError:
                assert cg == cw, (col, cg, cw)
                continue
            assert abs(fg - fw) <= tol * (1 + abs(fw)), (col, cg, cw)
