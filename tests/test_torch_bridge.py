"""The JAX -> PyTorch param bridge: a round trip back through the JAX
converter reproduces the JAX params bit-exactly."""

import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu.models.convert import torch_to_flax_params
from audioeditingcode_tpu_torch.models.bridge import (
    flax_location,
    flax_to_torch_state_dict,
)
from test_torch_helpers import jax_tiny_pipeline, port_tiny_pipeline


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_pipeline(10)
    return jpipe, port_tiny_pipeline(10, jpipe)


@pytest.mark.parametrize("part", ["unet", "vae", "vocoder"])
def test_bridge_round_trip_is_bit_exact(pipes, part):
    jpipe, pipe = pipes
    jparams = getattr(jpipe, part + "_params")
    sd = {k: v.numpy() for k, v in getattr(pipe, part).state_dict().items()}
    back = torch_to_flax_params(sd, jparams["params"], strict=True)
    want = flatten_dict(jparams["params"])
    got = flatten_dict(back)
    assert set(got) == set(want)
    for path, a in want.items():
        b = np.asarray(got[path])
        assert b.dtype == np.asarray(a).dtype and b.shape == np.shape(a), path
        assert np.array_equal(b, np.asarray(a)), path


def test_bridge_uses_diffusers_names(pipes):
    _, pipe = pipes
    keys = set(pipe.unet.state_dict())
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight" in keys
    assert "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight" in keys
    assert "up_blocks.0.upsamplers.0.conv.weight" in keys
    assert "encoder.down_blocks.0.downsamplers.0.conv.weight" in set(pipe.vae.state_dict())
    assert flax_location(pipe.vocoder, "ups.3.weight")[:2] == (("ups_3",), "kernel")


def test_bridge_rejects_mismatches(pipes):
    jpipe, pipe = pipes
    flat = dict(flatten_dict(jpipe.vocoder_params))
    extra = dict(flat)
    extra[("params", "conv_pre", "stray")] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="no torch target"):
        flax_to_torch_state_dict(extra, pipe.vocoder)
    missing = {k: v for k, v in flat.items() if k[1] != "conv_post"}
    with pytest.raises(KeyError, match="conv_post"):
        flax_to_torch_state_dict(missing, pipe.vocoder)
