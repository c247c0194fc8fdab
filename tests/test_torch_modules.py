"""Each model module of the port against its Flax counterpart, in float32,
with the Flax params carried over by the bridge and the same numpy inputs.
Whole-module forwards agree to 1e-4 relative (GroupNorm/LayerNorm compute
their variance differently, and sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from audioeditingcode_tpu.models import attention as jatt
from audioeditingcode_tpu.models import resnet as jres
from audioeditingcode_tpu_torch.models import attention as tatt
from audioeditingcode_tpu_torch.models import resnet as tres
from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
from test_torch_helpers import jax_tiny_pipeline, port_tiny_pipeline, rel_err, to_np

TOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(to_np(t), (0, 2, 3, 1))


def _carry(jmod, tmod, *args):
    """Init the Flax module, load its params into the torch one, return the
    Flax output."""
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    # non-trivial norm scales and biases, so that their layout is exercised
    rng = np.random.default_rng(1)
    flat = {k: (np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
                if k[-1] in ("scale", "bias") else np.asarray(v))
            for k, v in flatten_dict(variables).items()}
    tmod.load_state_dict(flax_to_torch_state_dict(flat, tmod))
    return np.asarray(jmod.apply(unflatten_dict(flat), *args))


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_pipeline(10)
    return jpipe, port_tiny_pipeline(10, jpipe)


@pytest.mark.parametrize("cin,cout,temb,eps", [(32, 32, 64, 1e-5), (16, 32, None, 1e-6)])
def test_resnet_block(cin, cout, temb, eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 10, cin), dtype=np.float32)
    t = rng.standard_normal((2, temb), dtype=np.float32) if temb else None
    jmod = jres.ResnetBlock2D(cout, use_time_emb=temb is not None, norm_num_groups=8, eps=eps)
    tmod = tres.ResnetBlock2D(cin, cout, temb, 8, eps=eps)
    want = _carry(jmod, tmod, jnp.asarray(x), None if t is None else jnp.asarray(t))
    got = tmod(_nchw(x), None if t is None else torch.from_numpy(t))
    assert rel_err(_nhwc(got), want) < TOL


def test_up_down_sample_and_vae_attention():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 7, 5, 16), dtype=np.float32)
    for jmod, tmod, kw in ((jres.Downsample2D(16), tres.Downsample2D(16), {}),
                           (jres.Upsample2D(16), tres.Upsample2D(16), {"output_size": (13, 10)}),
                           (jres.AttnBlock2D(16, 4), tres.AttnBlock2D(16, 4), {})):
        want = _carry(jmod, tmod, jnp.asarray(x), *kw.values())
        got = tmod(_nchw(x), *kw.values())
        assert rel_err(_nhwc(got), want) < TOL, type(tmod).__name__


@pytest.mark.parametrize("linear,hw", [(False, (8, 16)), (True, (6, 5)), (False, (64, 16))])
def test_transformer2d(linear, hw):
    """(64, 16) gives 1024 tokens: both attentions take the kernel branch."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2,) + hw + (32,), dtype=np.float32)
    jmod = jatt.Transformer2DModel(32, heads=4, head_dim=8, norm_num_groups=8,
                                   use_linear_projection=linear)
    tmod = tatt.Transformer2DModel(32, 4, 8, norm_num_groups=8, use_linear_projection=linear)
    want = _carry(jmod, tmod, jnp.asarray(x))
    assert rel_err(_nhwc(tmod(_nchw(x))), want) < TOL


@pytest.mark.parametrize("shape", [(2, 4, 16, 8), (1, 4, 256, 16)])
def test_unet(pipes, shape):
    """(1, 4, 256, 16): the level-0 self-attention has S = 4096 tokens and
    goes down the kernel branch (its plain version on the CPU)."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape, dtype=np.float32)
    prompts = ["a trumpet", ""][: shape[0]]
    for t in (901, 1):
        want = jpipe.unet_eps(jnp.asarray(x), jnp.asarray(t), jpipe.encode_text(prompts))
        got = pipe.unet_eps(torch.from_numpy(x), torch.tensor(t), pipe.encode_text(prompts))
        assert rel_err(to_np(got), want) < TOL


def test_vae_encode_decode(pipes):
    jpipe, pipe = pipes
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, 1, 63, 64), dtype=np.float32)  # start-padded to 64
    want = np.asarray(jpipe.vae_encode(jnp.asarray(mel)))
    got = to_np(pipe.vae_encode(torch.from_numpy(mel)))
    assert got.shape == want.shape == (1, 4, 32, 32)
    assert rel_err(got, want) < TOL
    z = rng.standard_normal((1, 4, 16, 32), dtype=np.float32)
    want = np.asarray(jpipe.vae_decode(jnp.asarray(z)))
    assert rel_err(to_np(pipe.vae_decode(torch.from_numpy(z))), want) < TOL


def test_hifigan(pipes):
    jpipe, pipe = pipes
    rng = np.random.default_rng(6)
    mel = rng.standard_normal((1, 1, 20, 64), dtype=np.float32)
    want = np.asarray(jpipe.decode_to_mel(jnp.asarray(mel)))
    got = to_np(pipe.decode_to_mel(torch.from_numpy(mel)))
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-audioldm2",
                                      "test/tiny-tango", "test/tiny-stable-audio"])
def test_seeded_weights_skip_the_default_init_and_stay_the_same(model_id):
    """registry.seeded (built on the meta device, no default init) gives
    random_init_(factory(), g)'s weights bit for bit, and every module of
    the pipeline holds no buffer the meta build would leave empty."""
    from audioeditingcode_tpu_torch.models import registry

    spec = registry.resolve_spec(model_id)
    pipe = registry.load_model(model_id, 4, device="cpu", seed=3)
    if model_id == "test/tiny-stable-audio":
        mods = [(pipe.dit, spec.dit), (pipe.vae, spec.oobleck), (pipe.projection, spec.projection)]
    else:
        mods = [(pipe.unet, spec.unet), (pipe.vae, spec.vae), (pipe.vocoder, spec.vocoder)]
    g = torch.Generator().manual_seed(3)
    for mod, cfg in mods:
        assert not list(mod.buffers())
        want = registry.random_init_(type(mod)(cfg), g).state_dict()
        for k, v in mod.state_dict().items():
            assert torch.equal(v, want[k].to(v.dtype)), k
