"""The port's Stable Audio modules against the JAX ones on test/tiny-stable-audio
params, on the CPU: the param bridge (bit-exact round trip through the JAX
converters), the DiT, the conditioning projection, the Oobleck VAE, the
null text encoder and the pipeline's conditioning.

Tolerances: 1e-4 relative (max abs error over max abs value) for the DiT and
the projection in float32. The Oobleck VAE with random weights is badly
conditioned: its 15 Snake layers amplify float32 roundoff, so a float32
forward lands ~5e-4 from the float64 result in either framework; its parity
bound is 3e-3, and the port's float32 error against its own float64 forward
must stay within twice the JAX package's."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu.models.dit1d import DiT1DConfig as JDiT1DConfig
from audioeditingcode_tpu.models.dit1d import StableAudioDiT as JStableAudioDiT
from audioeditingcode_tpu.models.dit1d import rotary_tables as j_rotary_tables
from audioeditingcode_tpu.models.text_encoders import NullTextEncoder as JNull
from audioeditingcode_tpu_torch.models import dit1d
from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
from audioeditingcode_tpu_torch.ops import flash_attention as fa
from audioeditingcode_tpu_torch.ops import swiglu
from test_torch_helpers import (
    jax_tiny_stable_audio,
    port_tiny_stable_audio,
    rel_err,
    to_np,
)
from tools.convert_checkpoint import convert_dit, convert_oobleck, convert_projection_sa

TOL = 1e-4


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_stable_audio(8)
    return jpipe, port_tiny_stable_audio(8, jpipe)


@pytest.mark.parametrize("part,convert", [
    ("dit", convert_dit), ("vae", convert_oobleck), ("projection", convert_projection_sa)])
def test_bridge_round_trip_is_bit_exact(pipes, part, convert):
    """JAX params -> bridge -> port state_dict -> the JAX converter, onto a
    zeroed template (the converters are not strict, so a leaf the port did
    not produce would stay zero and mismatch)."""
    jpipe, pipe = pipes
    module = pipe.vae if part == "vae" else getattr(pipe, part)
    jparams = getattr(jpipe, part + "_params")
    zeroed = jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)), jparams)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    back = flatten_dict(convert(sd, zeroed))
    want = flatten_dict(jparams)
    assert set(back) == set(want)
    for path, a in want.items():
        b = np.asarray(back[path])
        assert b.shape == np.shape(a), path
        assert np.array_equal(b, np.asarray(a)), path


def test_bridge_uses_diffusers_names(pipes):
    _, pipe = pipes
    keys = set(pipe.dit.state_dict())
    for k in ("transformer_blocks.0.attn1.to_out.0.weight", "transformer_blocks.1.ff.net.0.proj.bias",
              "transformer_blocks.0.ff.net.2.weight", "timestep_proj.0.bias", "timestep_proj.2.weight",
              "preprocess_conv.weight", "postprocess_conv.weight", "time_proj.weight"):
        assert k in keys, k
    assert tuple(pipe.dit.preprocess_conv.weight.shape) == (4, 4, 1)
    assert "decoder.block.1.conv_t1.weight" in set(pipe.vae.state_dict())
    assert tuple(pipe.vae.encoder.block[0].res_unit1.snake1.alpha.shape) == (1, 8, 1)
    assert ("start_number_conditioner.time_positional_embedding.0.weights"
            in set(pipe.projection.state_dict()))


def _dit_inputs(cfg, B, K, seed):
    rng = np.random.default_rng(seed)
    L = cfg.sample_size
    x = rng.standard_normal((B, L, cfg.in_channels)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, B).astype(np.float32)
    enc = rng.standard_normal((B, K, cfg.cross_attention_input_dim)).astype(np.float32)
    glob = rng.standard_normal((B, 1, cfg.global_states_input_dim)).astype(np.float32)
    return x, t, enc, glob


def test_dit_forward(pipes):
    jpipe, pipe = pipes
    cfg = jpipe.dit.config
    x, t, enc, glob = _dit_inputs(cfg, 2, 6, seed=0)
    want = jpipe.dit.apply(jpipe.dit_params, *map(jnp.asarray, (x, t, enc, glob)),
                           j_rotary_tables(cfg.rotary_embed_dim, cfg.sample_size + 1))
    with torch.no_grad():
        got = pipe.dit(*map(torch.from_numpy, (x, t, enc, glob)), pipe._rotary)
    assert rel_err(to_np(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("in_kernel", [False, True])
def test_narrow_dit_takes_both_kernel_branches(monkeypatch, in_kernel):
    """One full-length layer (S = 1025 tokens, E = 128): attn1 is eligible
    for the attention kernel and the FF for the SwiGLU kernel. The JAX side
    runs both Pallas kernels in interpret mode; the port's CPU tensors take
    the kernels' plain versions (the B2 one with AEC_ROTARY_IN_KERNEL=1)."""
    for env in ("PALLAS_INTERPRET_ATTENTION", "PALLAS_INTERPRET_SWIGLU"):
        monkeypatch.setenv(env, "1")
    monkeypatch.setenv("AEC_ROTARY_IN_KERNEL", "1" if in_kernel else "0")
    kw = dict(sample_size=1024, in_channels=8, out_channels=8, num_layers=1,
              attention_head_dim=64, num_attention_heads=2, num_key_value_attention_heads=1,
              cross_attention_dim=32, cross_attention_input_dim=32,
              global_states_input_dim=16, time_proj_dim=32)
    jcfg, cfg = JDiT1DConfig(**kw), dit1d.DiT1DConfig(**kw)
    x, t, enc, glob = _dit_inputs(cfg, 2, 5, seed=1)
    rot = j_rotary_tables(cfg.rotary_embed_dim, cfg.sample_size + 1)
    jdit = JStableAudioDiT(jcfg)
    params = jdit.init(jax.random.PRNGKey(0), *map(jnp.asarray, (x, t, enc, glob)), rot)
    want = jdit.apply(params, *map(jnp.asarray, (x, t, enc, glob)), rot)

    dit = dit1d.StableAudioDiT(cfg).eval()
    dit.load_state_dict(flax_to_torch_state_dict(flatten_dict(params), dit))
    ff = dit.transformer_blocks[0].ff.net[0].proj
    assert swiglu.kernel_eligible(torch.zeros(2, 1025, 128), ff.weight)
    calls = {"b1": 0, "b2": 0, "b3": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fa, "attention_reference", count("b1", fa.attention_reference))
    monkeypatch.setattr(fa, "rotary_attention_reference",
                        count("b2", fa.rotary_attention_reference))
    monkeypatch.setattr(swiglu, "swiglu_reference", count("b3", swiglu.swiglu_reference))
    with torch.no_grad():
        got = dit(*map(torch.from_numpy, (x, t, enc, glob)), dit1d.rotary_tables(32, 1025))
    assert rel_err(to_np(got), np.asarray(want)) < TOL
    # the B2 plain version calls the B1 one inside it
    assert calls == {"b1": 1, "b2": int(in_kernel), "b3": 1}


def test_projection_forward(pipes):
    jpipe, pipe = pipes
    rng = np.random.default_rng(2)
    txt = rng.standard_normal((2, 4, 32)).astype(np.float32)
    secs = (np.array([0.0, 3.0], np.float32), np.array([2.5, 600.0], np.float32))
    jproj, jp = jpipe.projection, jpipe.projection_params
    want = [jproj.apply(jp, jnp.asarray(txt), method=jproj.project_text),
            *jproj.apply(jp, *map(jnp.asarray, secs), method=jproj.encode_duration)]
    with torch.no_grad():
        got = [pipe.projection.project_text(torch.from_numpy(txt)),
               *pipe.projection.encode_duration(*map(torch.from_numpy, secs))]
    for g, w in zip(got, want):
        assert rel_err(to_np(g), np.asarray(w)) < TOL


@pytest.mark.parametrize("part", ["encode", "decode"])
def test_oobleck_forward(pipes, part):
    jpipe, pipe = pipes
    rng = np.random.default_rng(3)
    if part == "encode":
        x = rng.standard_normal((1, 2, 16 * pipe.hop_length)).astype(np.float32) * 0.3
        want = jpipe.vae.apply(jpipe.vae_params, jnp.asarray(x.transpose(0, 2, 1)),
                               method=jpipe.vae.encode)
        want = [np.asarray(w).transpose(0, 2, 1) for w in want]
    else:
        x = rng.standard_normal((1, 4, 16)).astype(np.float32)
        want = [np.asarray(jpipe.vae.apply(jpipe.vae_params, jnp.asarray(x.transpose(0, 2, 1)),
                                           method=jpipe.vae.decode)).transpose(0, 2, 1)]
    vae64 = copy.deepcopy(pipe.vae).double()
    fn = getattr(pipe.vae, part)
    with torch.no_grad():
        got = fn(torch.from_numpy(x))
        ref64 = getattr(vae64, part)(torch.from_numpy(x).double())
    got, ref64 = ([got], [ref64]) if part == "decode" else (got, ref64)
    for g, w, r in zip(got, want, ref64):
        r = r.numpy()
        assert rel_err(to_np(g), w) < 3e-3
        assert rel_err(to_np(g), r) <= 2 * rel_err(w, r) + 1e-6


def test_null_text_encoder_matches():
    """The full-size stream: 128 tokens of width 768, the empty prompt zero."""
    prompts = ["a dog barking", "", "piano"]
    want = JNull(hidden_dim=768, seq_len=128)(prompts)
    got = NullTextEncoder(hidden_dim=768, seq_len=128)(prompts)
    np.testing.assert_array_equal(got.hidden_states.numpy(), np.asarray(want.hidden_states))
    np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))


def test_pipeline_conditioning(pipes):
    """Duration embeds, global token, rotary tables, the empty-prompt marker
    and one CFG DiT forward through the pipeline's dit_forward."""
    jpipe, pipe = pipes
    jpipe.setup_duration(0.0, 0.01)
    pipe.setup_duration(0.0, 0.01)
    for a, b in ((pipe._duration_embeds, jpipe._duration_embeds),
                 (pipe._global_states, jpipe._global_states)):
        assert rel_err(to_np(a), np.asarray(b)) < 1e-6
    for a, b in zip(pipe._rotary, jpipe._rotary):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (pipe._waveform_start, pipe._waveform_end) == (jpipe._waveform_start,
                                                         jpipe._waveform_end)
    empty, jempty = pipe.encode_text([""]), jpipe.encode_text([""])
    assert not empty.attention_mask.any() and not np.asarray(jempty.attention_mask).any()
    x = np.random.default_rng(4).standard_normal((1, 4, pipe.sample_size)).astype(np.float32)
    cfg = torch.full((1, 4, pipe.sample_size), 6.0)
    den = pipe.make_denoiser(empty, pipe.encode_text(["a violin"]), cfg)
    jden = jpipe.make_denoiser(jempty, jpipe.encode_text(["a violin"]), jnp.asarray(cfg.numpy()))
    for k in (0, 5):
        with torch.no_grad():
            got = den(torch.from_numpy(x), k)
        assert rel_err(to_np(got), np.asarray(jden(jnp.asarray(x), jnp.asarray(k)))) < TOL
    jpipe.setup_duration()
    pipe.setup_duration()
