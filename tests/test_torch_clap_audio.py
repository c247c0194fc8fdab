"""The port's CLAP towers and checkpoint reader against the JAX package's
towers and transformers, on tiny ClapModels on the CPU.

Both packages' towers are built from one transformers ``ClapModel``: the
JAX package through ``params_from_torch_clap`` /
``text_params_from_torch_clap``, the port through a checkpoint directory
written by its own safetensors writer and read back by its reader (and,
once, through ``bridge.clap_state_dict_from_jax``). The audio tower's
stages, pooled output and embedding are held to JAX's at 1e-4 relative
(plus 1e-5 absolute near zero), the text embedding at 1e-4; the reader to
``safetensors.torch.load_file`` bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from audioeditingcode_tpu.models import clap_audio as j_clap
from audioeditingcode_tpu.models.clap_text import (clap_text_embed, clap_text_forward,
                                                   text_params_from_torch_clap)
from audioeditingcode_tpu_torch.models import clap_audio, hf_checkpoint
from audioeditingcode_tpu_torch.models.bridge import clap_state_dict_from_jax

TOL = {"rtol": 1e-4, "atol": 1e-5}


def _hf_clap(audio_kw, seed, vocab_size=100):
    from transformers import ClapAudioConfig, ClapConfig, ClapModel, ClapTextConfig

    tc = ClapTextConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64, vocab_size=vocab_size)
    ac = ClapAudioConfig(**audio_kw, drop_path_rate=0.0, attention_probs_dropout_prob=0.0,
                         hidden_dropout_prob=0.0)
    cfg = ClapConfig(text_config=tc.to_dict(), audio_config=ac.to_dict(),
                     projection_dim=audio_kw["projection_dim"])
    torch.manual_seed(seed)
    model = ClapModel(cfg).eval()
    bn = model.audio_model.audio_encoder.batch_norm  # non-trivial running stats
    bn.running_mean.copy_(torch.randn(bn.running_mean.shape) * 0.1)
    bn.running_var.copy_(torch.rand(bn.running_var.shape) + 0.5)
    return model


# tests/test_clap_audio.py's tiny geometry: two stages, 16 mel bins
TINY_AUDIO = dict(spec_size=64, num_mel_bins=16, patch_size=4, patch_stride=[4, 4],
                  window_size=4, depths=[2, 2], num_attention_heads=[2, 4],
                  patch_embeds_hidden_size=8, hidden_size=16, projection_dim=12)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """(transformers model, the port's model from its own checkpoint files,
    the checkpoint dir)."""
    hf = _hf_clap(TINY_AUDIO, seed=0)
    d = str(tmp_path_factory.mktemp("clap_ckpt"))
    hf_checkpoint.write_checkpoint(d, hf.config.to_dict(), hf.state_dict())
    return hf, clap_audio.load_clap(d), d


def test_state_dict_loads_strictly_and_the_reader_is_bit_equal(towers):
    from safetensors.torch import load_file

    hf, port, d = towers
    clap_audio.ClapModel(hf.config.to_dict()).load_state_dict(hf.state_dict(), strict=True)
    got = hf_checkpoint.read_safetensors(os.path.join(d, "model.safetensors"))
    want = load_file(os.path.join(d, "model.safetensors"))
    assert sorted(got) == sorted(want) == sorted(hf.state_dict())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    for k, v in port.state_dict().items():
        assert torch.equal(v, hf.state_dict()[k]), k


def test_pytorch_model_bin_reads_the_same(towers, tmp_path):
    hf, _, d = towers
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(hf.config.to_dict()))
    sd = hf_checkpoint.read_state_dict(str(tmp_path))
    assert all(torch.equal(sd[k], v) for k, v in hf.state_dict().items())
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf_checkpoint.read_state_dict(str(tmp_path / "nothing"))


def _jax_audio(hf):
    class Wrapper:  # params_from_torch_clap's duck-typed ClapModel
        audio_model, audio_projection, config = hf.audio_model, hf.audio_projection, \
            hf.config.audio_config

    return j_clap.params_from_torch_clap(Wrapper())


@pytest.mark.parametrize("frames", [50, 256])
def test_audio_tower_matches_jax(towers, frames):
    """Stages (the bicubic resampling at 50 frames, none at 256), pooled
    output and projected embedding."""
    hf, port, _ = towers
    params, cfg = _jax_audio(hf)
    x = np.random.default_rng(frames).standard_normal((2, 1, frames, 16)).astype(np.float32)
    want_stages, want_pooled = j_clap.clap_audio_forward(params, x, cfg)
    with torch.no_grad():
        stages, pooled = port.audio_forward(torch.from_numpy(x))
        emb = port.get_audio_features(torch.from_numpy(x))
    assert len(stages) == len(want_stages) == 3
    for g, w in zip(stages, want_stages):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), **TOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_clap.clap_audio_embed(params,
                                                                               want_pooled)),
                               **TOL)


def test_text_tower_matches_jax(towers):
    hf, port, _ = towers
    params, tcfg = text_params_from_torch_clap(hf)
    ids = np.asarray([[0, 5, 9, 12, 2, 1, 1, 1], [0, 7, 3, 4, 8, 11, 6, 2]])
    mask = (ids != 1).astype(np.int64)
    want = np.asarray(clap_text_embed(params, clap_text_forward(params, ids, mask, tcfg)))
    with torch.no_grad():
        got = port.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))
    got = got / torch.linalg.vector_norm(got, dim=-1, keepdim=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bridge_carries_the_jax_trees_over(towers):
    """The JAX param trees become the port's state dict: every tensor equal
    to transformers' (index buffers and logit scales are the model's own)."""
    hf, _, _ = towers
    params, _ = _jax_audio(hf)
    text_params, _ = text_params_from_torch_clap(hf)
    sd = clap_state_dict_from_jax(params, text_params)
    ref = hf.state_dict()
    assert set(sd) <= set(ref)
    assert {k.rsplit(".", 1)[-1] for k in set(ref) - set(sd)} == {
        "position_ids", "token_type_ids", "relative_position_index", "num_batches_tracked",
        "logit_scale_a", "logit_scale_t"}
    for k, v in sd.items():
        assert torch.equal(v, ref[k]), k
    model = clap_audio.load_clap_weights(clap_audio.ClapModel(hf.config.to_dict()), sd)
    x = torch.randn(1, 1, 40, 16)
    with torch.no_grad():
        torch.testing.assert_close(model.get_audio_features(x),
                                   hf.audio_projection(hf.audio_model(x).pooler_output),
                                   **TOL)


def test_helpers_match_jax():
    for n_in, n_out in ((50, 256), (1001, 1024), (7, 7)):
        np.testing.assert_allclose(clap_audio.cubic_resize_matrix(n_in, n_out),
                                   j_clap.cubic_resize_matrix(n_in, n_out), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(clap_audio.relative_position_index(8).numpy(),
                                  j_clap._relative_position_index(8))
    np.testing.assert_array_equal(clap_audio.shift_attn_mask(16, 16, 4, 2).numpy(),
                                  j_clap._shift_attn_mask(16, 16, 4, 2))


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    """The port's ClapExtractor (checkpoint dir: config.json,
    model.safetensors, preprocessor_config.json, tokenizer.json) and the
    JAX FlaxClapExtractor on one transformers ClapModel, at the geometry the
    processor's 1001 x 64 mel fits (tests/test_evals.py's)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors, trainers
    from transformers import ClapFeatureExtractor, ClapProcessor, RobertaTokenizerFast

    from audioeditingcode_tpu.evals.features import FlaxClapExtractor
    from audioeditingcode_tpu_torch.evals.features import ClapExtractor

    d = str(tmp_path_factory.mktemp("clap_extractor"))
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(["a trumpet playing a melody", "a cello and a violin"] * 10,
                            trainers.BpeTrainer(
                                vocab_size=300, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"]))
    tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    fast = RobertaTokenizerFast(tokenizer_object=tok, model_max_length=77)
    fast.save_pretrained(d)
    fe = ClapFeatureExtractor(truncation="rand_trunc")
    fe.save_pretrained(d)
    hf = _hf_clap(dict(hidden_size=32, depths=[1, 1], num_attention_heads=[2, 2],
                       num_mel_bins=64, spec_size=256, patch_embeds_hidden_size=16,
                       window_size=4, projection_dim=16), seed=3, vocab_size=400)
    hf_checkpoint.write_checkpoint(d, hf.config.to_dict(), hf.state_dict())
    port = ClapExtractor(d, device="cpu")
    jax = FlaxClapExtractor.from_components(hf, ClapProcessor(feature_extractor=fe,
                                                              tokenizer=fast))
    return port, jax


def test_extractor_matches_the_jax_tower(extractors):
    port, jax = extractors
    t = np.arange(3 * 16000, dtype=np.float32) / 16000
    aud = np.stack([0.4 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)])
    for g, w in zip(port.stages(aud, 16000), jax.stages(aud, 16000)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(port.embed_audio(aud, 16000), jax.embed_audio(aud, 16000), **TOL)
    texts = ["a trumpet", "a cello and a violin playing a melody"]
    np.testing.assert_allclose(port.embed_text(texts), jax.embed_text(texts), rtol=1e-4,
                               atol=1e-4)
