"""Converted checkpoints (``--weights_dir``) in the port against the JAX
package on the CPU, for test/tiny-audioldm (CLAP FiLM), test/tiny-audioldm2
(the CLAP + T5 + GPT-2 chain), test/tiny-tango (T5) and
test/tiny-stable-audio (T5 + projection): each checkpoint is built with the
helpers of tests/test_convert_integration.py and converted by the JAX
converter, then loaded by both packages.

Tolerances: the loaded weights bit-equal; the conditioning and one CFG
denoiser forward 1e-4 relative (max abs error over max abs value: whole
float32 forwards); the forward in bfloat16 within 1.25x the JAX bfloat16
forward's relative Frobenius error against the JAX float32 one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu.editing.cfg import build_cfg_tensors as jcfg
from audioeditingcode_tpu.models.registry import load_model as jload
from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors as tcfg
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
from test_torch_helpers import CKPT_STEPS, rel_err, to_np
from test_torch_helpers import converted_dirs, converted_pipelines as ckpt  # noqa: F401

MODELS = ["test/tiny-audioldm", "test/tiny-audioldm2", "test/tiny-tango",
          "test/tiny-stable-audio"]
STEPS = CKPT_STEPS
TOL = 1e-4
BF16_RATIO = 1.25  # the port's bf16 forward error over the JAX bf16 forward's
PROMPTS = ["a sine tone", "a loud trumpet, playing fast!  ok", ""]


def _parts(jpipe):
    if hasattr(jpipe, "dit"):
        return ("dit", "vae", "projection")
    return ("unet", "vae", "vocoder")


@pytest.mark.parametrize("model_id", MODELS)
def test_loaded_weights_match_jax(ckpt, model_id):
    _, jpipe, pipe = ckpt(model_id)
    for part in _parts(jpipe):
        mod = getattr(pipe, part)
        want = flax_to_torch_state_dict(flatten_dict(getattr(jpipe, part + "_params")), mod)
        got = mod.state_dict()
        assert set(got) == set(want), part
        for k, v in want.items():
            assert torch.equal(got[k], v), (part, k)


def _cond_np(c):
    return {f: np.asarray(getattr(c, f), np.float64) for f in
            ("hidden_states", "class_labels", "attention_mask", "hidden_states_1",
             "attention_mask_1") if getattr(c, f) is not None}


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("model_id", MODELS)
def test_encode_text_matches_jax(ckpt, model_id, negative):
    """Prompts of unequal lengths in one batch: masks with zeros reach the
    towers, and the real encoder (not the null one) is in place."""
    _, jpipe, pipe = ckpt(model_id)
    assert not isinstance(pipe.text_encoder, NullTextEncoder)
    want = _cond_np(jpipe.encode_text(PROMPTS, negative=negative))
    got = {k: v.double().numpy() for k, v in
           ((f, getattr(pipe.encode_text(PROMPTS, negative=negative), f)) for f in want)}
    assert set(got) == set(want)
    for k in want:
        if k.startswith("attention_mask"):
            np.testing.assert_array_equal(got[k], want[k])
            assert (want[k] == 0).any(), k  # padding reached the mask
        else:
            assert rel_err(got[k], want[k]) < TOL, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_id", MODELS)
def test_cfg_forward_matches_jax(ckpt, model_id, dtype):
    """One CFG-fused denoiser forward on the loaded weights and the real
    conditioning: an empty negative prompt, a source and a target. In
    bfloat16 (the towers stay float32) the padded T5 masks meet the bf16
    attention bias. Its relative Frobenius error against the JAX float32
    forward is held to BF16_RATIO times the JAX bfloat16 forward's (3.6e-2
    on the tiny AudioLDM: bf16 rounding alone)."""
    wd, jpipe, pipe = ckpt(model_id)
    jpipes = [jpipe]
    if dtype == "bfloat16":
        pipe = treg.load_model(model_id, STEPS, device="cpu", dtype=torch.bfloat16,
                               weights_dir=wd)
        jpipes.append(jload(model_id, STEPS, weights_dir=wd, dtype=jnp.bfloat16))
    if hasattr(jpipe, "dit"):
        shape = (1, jpipe.dit.config.in_channels, jpipe.sample_size)
    else:
        shape = (1, jpipe.unet.config.in_channels, 8, 64 // jpipe.vae_pad_multiple)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    prompt = ["a loud trumpet, playing fast!"]
    outs = [np.asarray(p.make_denoiser(p.encode_text([""], negative=True), p.encode_text(prompt),
                                       jcfg(shape, prompt, [3.0])[0])(jnp.asarray(x), 1),
                       np.float32) for p in jpipes]
    tden = pipe.make_denoiser(pipe.encode_text([""], negative=True),
                              pipe.encode_text(prompt), tcfg(shape, prompt, [3.0])[0])
    want = outs[0]
    got = to_np(tden(torch.from_numpy(x), 1))
    if dtype == "float32":
        assert rel_err(got, want) < TOL
    else:
        fro = [np.linalg.norm(o - want) / np.linalg.norm(want) for o in (got, outs[1])]
        assert fro[0] <= BF16_RATIO * fro[1], fro
