"""The AudioLDM2 (dual-stream), AudioLDM-l and TANGO UNets of the port
against the JAX package on the CPU: specs, weight-free text encoders, UNet
forwards with both streams and their key masks, the bridge, the full-size
state-dict names against the diffusers checkpoints' key manifests, tiny
edits through the loops (TANGO through v-prediction) and through the CLIs.

Tolerances (max abs error over max abs value): UNet forwards 1e-4 (whole
float32 forwards on the same inputs; measured ~2e-6); tiny edits 2e-4 (a
chain of forwards, each side on its own outputs, as tests/test_torch_e2e.py);
the bridge and the null text encoders bit-exact."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu.cli import run as jrun
from audioeditingcode_tpu.editing import cfg as jcfg
from audioeditingcode_tpu.editing import invert as jinv
from audioeditingcode_tpu.models import configs as jconfigs
from audioeditingcode_tpu.models.convert import torch_to_flax_params
from audioeditingcode_tpu.ops import flash_attention as jfa
from audioeditingcode_tpu.utils import audio_io as jio
from audioeditingcode_tpu_torch.cli import pc_extract as tpe
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.cli import sdedit as tsdedit
from audioeditingcode_tpu_torch.editing import cfg as tcfg
from audioeditingcode_tpu_torch.editing import invert as tinv
from audioeditingcode_tpu_torch.models import configs as tconfigs
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.text_encoders import TextCond
from audioeditingcode_tpu_torch.models.unet2d import UNet2DConditionModel
from audioeditingcode_tpu_torch.ops import flash_attention as tfa
from audioeditingcode_tpu_torch.utils import audio_io as tio
from test_torch_helpers import (
    REPO,
    jax_tiny_pipeline,
    port_tiny_pipeline,
    rel_err,
    to_np,
    write_test_wav,
)

TINY = ("test/tiny-audioldm2", "test/tiny-tango")
STEPS = 8
FWD_TOL = 1e-4
EDIT_TOL = 2e-4
FULL_SIZE = ("cvssp/audioldm-s-full-v2", "cvssp/audioldm-l-full", "cvssp/audioldm2",
             "cvssp/audioldm2-large", "cvssp/audioldm2-music",
             "declare-lab/tango-full-ft-audio-music-caps", "declare-lab/tango-full-ft-audiocaps")


@pytest.fixture(scope="module")
def pipes():
    out = {}
    for m in TINY:
        jpipe = jax_tiny_pipeline(STEPS, m)
        out[m] = jpipe, port_tiny_pipeline(STEPS, jpipe, m)
    return out


@pytest.mark.parametrize("model_id", sorted(tconfigs.MODEL_SPECS))
def test_specs_match_jax(model_id):
    """Every field the port's spec has is the JAX spec's, configs field by
    field (the port's configs leave out what it does not port, such as the
    VQ fields of the image models' VAE)."""
    want, got = jconfigs.MODEL_SPECS[model_id], tconfigs.MODEL_SPECS[model_id]
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == {k: b[k] for k in a}, f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("model_id", sorted(jconfigs.MODEL_SPECS))
def test_every_jax_model_id_resolves_or_names_its_item(model_id):
    """A JAX model id is ported or raises NotImplementedError naming the
    ROADMAP item that adds it (never a bare unknown-id KeyError)."""
    if model_id in tconfigs.MODEL_SPECS:
        assert treg.resolve_spec(model_id).model_id == model_id
    else:
        with pytest.raises(NotImplementedError, match=r"Queue A item \d+"):
            treg.resolve_spec(model_id)


@pytest.mark.parametrize("model_id", FULL_SIZE)
def test_full_size_unet_names_match_the_checkpoint_manifest(model_id):
    """The full-size UNet (built without memory) has exactly the keys and
    shapes of the diffusers checkpoint (data/key_manifests), so a real
    state dict converts name for name: the dual-stream attentions.{2j} /
    {2j+1} of AudioLDM2, the linear proj_in/proj_out of AudioLDM2 and TANGO."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(tconfigs.MODEL_SPECS[model_id].unet)
    got = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    want = {}
    path = os.path.join(REPO, "data", "key_manifests", model_id.replace("/", "__"), "unet.txt")
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                key, shape = line.rstrip("\n").split("\t")
                want[key] = tuple(int(d) for d in shape.split(",")) if shape else ()
    assert got == want


@pytest.mark.parametrize("model_id", TINY)
def test_null_text_encoders_match_jax(pipes, model_id):
    """AudioLDM2: 8 tokens at the GPT-2 width and text_seq_len at the
    projected width, each with its mask; TANGO: min(text_seq_len, 64) T5
    tokens. Bit-equal to the JAX encoder's."""
    jpipe, pipe = pipes[model_id]
    want, got = jpipe.encode_text(["a trumpet", ""]), pipe.encode_text(["a trumpet", ""])
    for f in dataclasses.fields(TextCond):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    shapes = {f.name: tuple(getattr(got, f.name).shape)
              for f in dataclasses.fields(TextCond) if getattr(got, f.name) is not None}
    assert shapes == ({"hidden_states": (2, 8, 24), "attention_mask": (2, 8),
                       "hidden_states_1": (2, 6, 40), "attention_mask_1": (2, 6)}
                      if model_id == TINY[0] else
                      {"hidden_states": (2, 16, 32), "attention_mask": (2, 16)})


def _cond(pipe_cond, masked_tail: int, lib):
    """The CFG pair's conditioning, optionally with the last masked_tail
    tokens of the conditional row's streams masked out."""
    fields = {}
    for f in dataclasses.fields(TextCond):
        v = getattr(pipe_cond, f.name)
        if v is None:
            continue
        v = np.array(v)
        if f.name.startswith("attention_mask") and masked_tail:
            v[1, -masked_tail:] = 0
        fields[f.name] = lib(v)
    return fields


@pytest.mark.parametrize("masked_tail", [0, 3])
@pytest.mark.parametrize("model_id", TINY)
def test_unet_forward_matches_jax(pipes, model_id, masked_tail):
    """A CFG-batch forward at a mid timestep, with each stream's key mask
    reaching mask_to_bias (three masked tokens per stream in one case)."""
    jpipe, pipe = pipes[model_id]
    cond = jpipe.encode_text(["", "a trumpet"])
    x = np.random.default_rng(1).standard_normal((2, 4, 24, 16)).astype(np.float32)
    want = np.asarray(jpipe.unet_eps(jnp.asarray(x), jpipe.sched.timesteps[3],
                                     type(cond)(**_cond(cond, masked_tail, jnp.asarray))))
    got = to_np(pipe.unet_eps(torch.from_numpy(x), pipe.sched.timesteps[3],
                              TextCond(**_cond(cond, masked_tail, torch.from_numpy))))
    assert rel_err(got, want) < FWD_TOL


@pytest.mark.parametrize("model_id,stream", [(TINY[0], ""), (TINY[0], "_1"), (TINY[1], "")])
def test_masked_tokens_do_not_reach_the_output(pipes, model_id, stream):
    """Tokens that a stream's mask drops can hold anything: each stream's
    mask reaches its own cross-attention as a -1e4 bias."""
    _, pipe = pipes[model_id]
    cond = pipe.encode_text(["a trumpet"])
    mask = getattr(cond, "attention_mask" + stream).clone()
    mask[:, -2:] = 0
    hs = getattr(cond, "hidden_states" + stream)
    x = torch.randn(1, 4, 24, 16, generator=torch.Generator().manual_seed(2))
    t = pipe.sched.timesteps[2]
    outs = []
    for fill in (0.0, 50.0):
        junk = hs.clone()
        junk[:, -2:] = fill
        outs.append(pipe.unet_eps(x, t, dataclasses.replace(
            cond, **{"attention_mask" + stream: mask, "hidden_states" + stream: junk})))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    unmasked = pipe.unet_eps(x, t, dataclasses.replace(cond, **{"hidden_states" + stream: junk}))
    assert not torch.equal(unmasked, outs[1])


@pytest.mark.parametrize("q_len,kv_len", [(1024, 64), (1024, 8), (64, 1024)])
def test_cross_attention_takes_the_plain_path(q_len, kv_len):
    """Cross-attention (Q != K), masked, is never the kernel's, as in the
    JAX dispatcher, and matches the JAX dispatcher's result."""
    rng = np.random.default_rng(q_len + kv_len)
    q = rng.standard_normal((2, q_len, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, kv_len, 4, 16)).astype(np.float32) for _ in range(2))
    mask = np.ones((2, kv_len), np.float32)
    mask[1, kv_len // 2:] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    for b in (None, bias):
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tb = None if b is None else torch.from_numpy(b)
        assert not tfa.kernel_eligible(tq, tk, tb)
        got = tfa.fused_attention(tq, tk, tv, bias=tb)
        torch.testing.assert_close(got, tfa._plain_attention(tq, tk, tv, tb), rtol=0, atol=0)
        want = np.asarray(jfa.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              bias=None if b is None else jnp.asarray(b)))
        assert rel_err(to_np(got), want) < FWD_TOL


@pytest.mark.parametrize("part", ["unet", "vae", "vocoder"])
@pytest.mark.parametrize("model_id", TINY)
def test_bridge_round_trip_is_bit_exact(pipes, model_id, part):
    jpipe, pipe = pipes[model_id]
    jparams = getattr(jpipe, part + "_params")
    sd = {k: v.numpy() for k, v in getattr(pipe, part).state_dict().items()}
    back = flatten_dict(torch_to_flax_params(sd, jparams["params"], strict=True))
    want = flatten_dict(jparams["params"])
    assert set(back) == set(want)
    for path, a in want.items():
        b = np.asarray(back[path])
        assert b.dtype == np.asarray(a).dtype and np.array_equal(b, np.asarray(a)), path


def _edit(lib, p, x0, src, tgt, noise):
    """The whole edit through one package's loops: inversion with the source
    prompt, then the edit with the target; returns the edited latent, the
    noise maps and the output wav."""
    cfgm, inv = (jcfg, jinv) if lib == "jax" else (tcfg, tinv)
    arr = jnp.asarray if lib == "jax" else torch.from_numpy
    w0 = p.vae_encode(arr(x0))
    empty = p.encode_text([""], negative=True)
    cs, _ = cfgm.build_cfg_tensors(w0.shape, [src], [3.0], zero_empty_prompts=True)
    ct, _ = cfgm.build_cfg_tensors(w0.shape, [tgt], [12.0])
    _, zs, xts = inv.inversion_forward_process(
        p.sched, p.make_denoiser(empty, p.encode_text([src]), cs), w0,
        jax.random.PRNGKey(3) if lib == "jax" else torch.from_numpy(noise))
    w = inv.inversion_reverse_process(p.sched, p.make_denoiser(empty, p.encode_text([tgt]), ct),
                                      xts, zs[:6])
    out = {"zs": zs, "w_edit": w, "wav": p.decode_to_mel(p.vae_decode(w))}
    return {k: np.asarray(v) if lib == "jax" else to_np(v) for k, v in out.items()}


@pytest.mark.parametrize("model_id", TINY)
def test_tiny_edit_matches_jax(pipes, model_id, tmp_path):
    """The --mode ours edit through the loops, both packages on the same
    wav, params and inversion noise (the JAX draw); TANGO through its
    v-prediction schedule."""
    jpipe, pipe = pipes[model_id]
    assert pipe.sched.prediction_type == ("v_prediction" if "tango" in model_id else "epsilon")
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.4)
    x0, _, _ = jio.load_audio(wav, jpipe.mel_config)
    w0_shape = jpipe.vae_encode(jnp.asarray(x0)).shape
    noise = np.array(jax.random.normal(jax.random.PRNGKey(3), (STEPS,) + tuple(w0_shape)))
    want = _edit("jax", jpipe, x0, "a sine tone", "a trumpet", None)
    got = _edit("port", pipe, tio.load_audio(wav, pipe.mel_config)[0], "a sine tone",
                "a trumpet", noise)
    errs = {k: rel_err(got[k], want[k]) for k in want}
    assert max(errs.values()) < EDIT_TOL, errs


@pytest.mark.parametrize("model_id", TINY)
def test_bfloat16_forward_takes_float32_conditioning(pipes, model_id):
    """A bf16 UNet takes the encoders' float32 text streams (cast to the
    module dtype, as the Flax modules do) and lands near the float32
    forward: relative Frobenius error within 3e-2, the repo's bf16 bound."""
    _, pipe = pipes[model_id]
    bf16 = treg.load_model(model_id, STEPS, device="cpu", dtype=torch.bfloat16)
    bf16.unet.load_state_dict(pipe.unet.state_dict())
    cond = pipe.encode_text(["a trumpet"])
    x = torch.randn(1, 4, 24, 16, generator=torch.Generator().manual_seed(5))
    t = pipe.sched.timesteps[2]
    ref = pipe.unet_eps(x, t, cond).double()
    got = bf16.unet_eps(x, t, cond)
    assert got.dtype == torch.float32
    assert ((got.double() - ref).norm() / ref.norm()).item() < 3e-2


def test_tiny_audioldm2_selfcheck_through_both_clis(tmp_path):
    """--mode ours with --selfcheck on test/tiny-audioldm2 through the JAX
    CLI and the port's (also in bfloat16): the same results layout, each
    >= 40 dB."""
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.4)
    argv = ["--model_id", TINY[0], "--init_aud", wav, "--num_diffusion_steps", "6",
            "--tstart", "4", "--source_prompt", "a sine tone", "--target_prompt", "a trumpet",
            "--selfcheck", "--seed", "0"]
    outs = {"jax": jrun.main(argv + ["--results_path", str(tmp_path / "jax")]),
            "port": trun.main(argv + ["--device", "cpu", "--results_path",
                                      str(tmp_path / "port")])}
    assert (os.path.relpath(os.path.dirname(outs["jax"]), tmp_path / "jax")
            == os.path.relpath(os.path.dirname(outs["port"]), tmp_path / "port"))
    outs["port_bf16"] = trun.main(argv + ["--device", "cpu", "--dtype", "bfloat16",
                                          "--results_path", str(tmp_path / "port_bf16")])
    for out in outs.values():
        assert os.path.basename(out).startswith("selfcheck_cfg_e_3_cfg_d_12_skip_2_")
        with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
            assert json.load(f)["selfcheck_snr_db"] >= 40.0


def test_default_model_id_is_ported():
    """The CLIs' default --model_id (AudioLDM2-music) resolves in the port,
    and its full-size UNet builds (without memory)."""
    defaults = {cli.build_parser().get_default("model_id") for cli in (trun, tpe, tsdedit)}
    assert defaults == {"cvssp/audioldm2-music"}
    spec = treg.resolve_spec(defaults.pop())
    with torch.device("meta"):
        unet = UNet2DConditionModel(spec.unet)
    assert len(unet.down_blocks[0].attentions) == 4  # 2 positions x 2 streams


def test_tiny_pc_extraction_on_audioldm2(tmp_path):
    """PC extraction through the port's CLI on the dual-stream UNet."""
    wav = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    ckpt = tpe.main(["--device", "cpu", "--model_id", TINY[0], "--init_aud", wav,
                     "--num_diffusion_steps", "6", "--n_evs", "2", "--drift_start", "4",
                     "--drift_end", "2", "--iters", "3", "--seed", "0", "--wandb_disable",
                     "--results_path", str(tmp_path)])
    z = np.load(ckpt)
    assert z["eig_vals"].shape == (2, 2) and np.all(np.isfinite(z["eig_vals"]))
    assert np.all(z["eig_vals"] > 0) and np.all(np.isfinite(z["eig_vecs"]))


def test_tango_rejects_audio_longer_than_its_maximum():
    pipe = treg.load_model(TINY[1], 4, device="cpu")
    assert pipe.max_mel_frames == 1700
    with pytest.raises(ValueError, match="too long"):
        pipe.vae_encode(torch.zeros(1, 1, 1704, 64))
