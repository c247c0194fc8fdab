"""The text towers of the port against transformers and the JAX package on
the CPU: the tokenizers (models/tokenizers.py) against AutoTokenizer, the
T5 encoder and RoBERTa with its pooler against transformers' Flax models,
the CLAP FiLM vector against the JAX registry's, and GPT-2's generation
and the AudioLDM2 projection against the JAX modules, each on the same
weights.

Prompts of unequal lengths go in one batch: the RoBERTa position ids and
T5's relative buckets show only in values. Tolerances: token ids equal;
float32 forwards 1e-4 relative (max abs error over max abs value)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from audioeditingcode_tpu.models import audioldm2_cond as jcond
from audioeditingcode_tpu_torch.models import audioldm2_cond as tcond
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.configs import AudioLDM2ProjectionConfig, GPT2Config
from audioeditingcode_tpu_torch.models.text_encoders import (
    load_text_tower,
    relative_position_buckets,
)
from audioeditingcode_tpu_torch.models.tokenizers import Tokenizer, gpt2_split
from test_torch_helpers import rel_err, to_np

TOL = 1e-4
PROMPTS = ["a trumpet", "", "Hello, World!  It's 2024 --  café   naïve, don't",
           "  leading and trailing  ", "tab\there\nnew line", "<pad> </s>x<unk> y",
           "x" * 40, "日本語 ١٢٣ ½ ﬁne ｗｉｄｅ", "ｅ́ é é"]


def _assert_same_tokens(d, prompts, **kw):
    from transformers import AutoTokenizer

    ref = AutoTokenizer.from_pretrained(d)
    mine = Tokenizer.from_dir(d)
    for padding in ("max_length", True):
        want = ref(prompts, padding=padding, truncation=True, return_tensors="np", **kw)
        ids, mask = mine(prompts, padding=padding, **kw)
        np.testing.assert_array_equal(ids, want["input_ids"])
        np.testing.assert_array_equal(mask, want["attention_mask"])


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """t5/ and clap_text/ as the JAX converter exports them."""
    import test_convert_integration as tci
    from tools.convert_checkpoint import _export_clap_text, _export_t5

    root = tmp_path_factory.mktemp("towers")
    src, out = str(root / "src"), str(root / "out")
    torch.manual_seed(0)
    tci.make_t5_model_dir(os.path.join(src, "text_encoder"), d_model=32)
    tci.make_t5_tokenizer_dir(os.path.join(src, "tokenizer"))
    tci.make_clap_text_model_dir(os.path.join(src, "clap"), projection_dim=16)
    tci.make_roberta_tokenizer_dir(os.path.join(src, "clap_tok"))
    _export_t5(src, out)
    os.rename(os.path.join(src, "clap"), os.path.join(src, "text_encoder_c"))
    # _export_clap_text reads <src>/text_encoder and <src>/tokenizer
    csrc = str(root / "csrc")
    os.makedirs(csrc)
    os.rename(os.path.join(src, "text_encoder_c"), os.path.join(csrc, "text_encoder"))
    os.rename(os.path.join(src, "clap_tok"), os.path.join(csrc, "tokenizer"))
    _export_clap_text(csrc, out)
    assert os.path.isdir(os.path.join(out, "t5")) and os.path.isdir(os.path.join(out, "clap_text"))
    return out


@pytest.mark.parametrize("name,max_length", [("t5", None), ("t5", 8), ("clap_text", None),
                                             ("clap_text", 6)])
def test_tokens_match_autotokenizer_on_converted_dirs(towers, name, max_length):
    kw = {} if max_length is None else {"max_length": max_length}
    _assert_same_tokens(os.path.join(towers, name), PROMPTS, **kw)


def _darts(mapping):
    """A Darts double-array blob of sentencepiece's precompiled charsmap:
    u32 trie size, the units, then the NUL-terminated replacements."""
    norm, values = b"", {}
    for k, v in sorted(mapping.items()):
        values[k.encode()] = len(norm)
        norm += v.encode() + b"\0"
    trie = {}
    for k, val in values.items():
        node = trie
        for c in k:
            node = node.setdefault(c, {})
        node[None] = val
    units, used = [0] * 4096, {0}
    todo = [(0, trie)]
    while todo:
        idx, node = todo.pop(0)
        labels = [c for c in node if c is not None] + ([0] if None in node else [])
        base = next(b for b in range(1, 4096) if all((b ^ c) not in used for c in labels))
        units[idx] |= (idx ^ base) << 10
        if None in node:
            units[idx] |= 1 << 8
            units[base] = node[None] | (1 << 31)
            used.add(base)
        for c in sorted(c for c in node if c is not None):
            units[base ^ c] = c
            used.add(base ^ c)
            todo.append((base ^ c, node[c]))
    n = max(used) + 1
    return len(units[:n] * 4).to_bytes(4, "little") + np.asarray(units[:n], "<u4").tobytes() + norm


def test_unigram_with_precompiled_normalizer(tmp_path):
    """A FLAN-T5-shaped tokenizer.json: Precompiled (a charsmap written
    here) + Replace(" {2,}"), Metaspace, Unigram with real scores."""
    from tokenizers import Regex, Tokenizer as HFTokenizer, models, normalizers, \
        pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    charsmap = _darts({"ﬁ": "fi", "ｗ": "w", "ｉ": "i", "ｄ": "d", "ｅ": "e", " ": " ",
                       "é": "é", "ｅ́": "é", "½": "1/2", "\t": " "})
    pieces = ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
              + [("▁" + w, -1.0 - 0.1 * len(w)) for w in ("a", "the", "trumpet", "fine",
                                                       "wide", "café", "é", "1/2", "new")]
              + [(c, -4.0 - 0.01 * i) for i, c in enumerate("abcdefghijklmnopqrstuvwxyzé/12")]
              + [("▁", -3.0), ("tr", -2.5), ("um", -2.6), ("pet", -2.7)])
    tok = HFTokenizer(models.Unigram(pieces, unk_id=2))
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(charsmap),
                                           normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                                   unk_token="<unk>", model_max_length=24)
    fast.save_pretrained(str(tmp_path))
    with open(tmp_path / "tokenizer.json") as f:
        assert json.load(f)["normalizer"]["normalizers"][0]["type"] == "Precompiled"
    _assert_same_tokens(str(tmp_path), PROMPTS + ["the  trumpet is ﬁne", "ｗｉｄｅ 1/2"])


def test_byte_level_bpe_with_merges(tmp_path):
    """A RoBERTa tokenizer.json with merges learned here: ByteLevel
    pre-tokenizer, BPE by rank, RobertaProcessing."""
    from tokenizers import Tokenizer as HFTokenizer, models, pre_tokenizers, processors, \
        trainers
    from transformers import RobertaTokenizerFast

    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    corpus = ["a trumpet playing a melody", "the cat's trumpets aren't playing",
              "hello world, hello there 2024 2025", "café naïve résumé"] * 20
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    fast = RobertaTokenizerFast(tokenizer_object=tok, model_max_length=20)
    fast.save_pretrained(str(tmp_path))
    with open(tmp_path / "tokenizer.json") as f:
        assert len(json.load(f)["model"]["merges"]) > 50
    _assert_same_tokens(str(tmp_path), PROMPTS + ["the trumpets aren't playing'll 've",
                                                  "hello <mask> world  \n  x"])


def test_gpt2_split_matches_the_regex_cases():
    assert gpt2_split("Hello world's  end!!\n\n x 12ab") == \
        ["Hello", " world", "'s", " ", " end", "!!", "\n\n", " x", " 12", "ab"]
    assert gpt2_split("  a") == [" ", " a"] and gpt2_split("a  ") == ["a", "  "]


def test_unsupported_component_raises(tmp_path):
    spec = {"model": {"type": "WordPiece", "vocab": {}}, "added_tokens": []}
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError, match="WordPiece"):
        Tokenizer.from_dir(str(tmp_path))


def test_relative_buckets_match_flax():
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    for nb, md in ((32, 128), (32, 20), (16, 40)):
        want = np.asarray(FlaxT5Attention._relative_position_bucket(
            jnp.arange(600)[None, :] - jnp.arange(600)[:, None], True, nb, md))
        np.testing.assert_array_equal(relative_position_buckets(600, 600, nb, md).numpy(), want)


def _ids_and_mask(vocab, lengths, seq, pad, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(3, vocab, (len(lengths), seq))
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
        ids[i, n:] = pad
    return ids, mask


@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_t5_encoder_matches_flax(tmp_path, proj):
    """Layer 0's relative buckets shared by all layers, RMS norms, unscaled
    scores; sequences long enough for the logarithmic buckets."""
    from transformers import FlaxT5EncoderModel, T5Config, T5EncoderModel

    torch.manual_seed(1)
    cfg = T5Config(d_model=32, d_ff=48, d_kv=8, num_layers=2, num_heads=4, vocab_size=70,
                   feed_forward_proj=proj, relative_attention_max_distance=20)
    T5EncoderModel(cfg).save_pretrained(str(tmp_path / "pt"), safe_serialization=False)
    flax_model = FlaxT5EncoderModel.from_pretrained(str(tmp_path / "pt"), from_pt=True)
    flax_model.save_pretrained(str(tmp_path / "t5"))
    ids, mask = _ids_and_mask(70, [40, 17, 3], 40, 0, seed=2)
    want = np.asarray(flax_model(input_ids=ids, attention_mask=mask).last_hidden_state)
    t5 = load_text_tower(str(tmp_path / "t5"))
    got = t5(torch.from_numpy(ids), torch.from_numpy(mask))
    assert rel_err(to_np(got), want) < TOL
    # the same weights saved in shards (flax_model.msgpack.index.json)
    flax_model.save_pretrained(str(tmp_path / "t5_shards"), max_shard_size="20KB")
    assert os.path.exists(tmp_path / "t5_shards" / "flax_model.msgpack.index.json")
    sharded = load_text_tower(str(tmp_path / "t5_shards")).state_dict()
    assert all(torch.equal(sharded[k], v) for k, v in t5.state_dict().items())


def test_roberta_and_clap_film_match_jax(towers):
    """RoBERTa's hidden states and pooler against FlaxRobertaModel, and the
    CLAP FiLM vector against the JAX registry's encoder."""
    from transformers import FlaxRobertaModel

    from audioeditingcode_tpu.models.registry import _try_clap_film

    d = os.path.join(towers, "clap_text")
    flax_model = FlaxRobertaModel.from_pretrained(d)
    ids, mask = _ids_and_mask(120, [16, 5, 2], 16, 1, seed=3)
    out = flax_model(input_ids=ids, attention_mask=mask)
    h, pooled = load_text_tower(d)(torch.from_numpy(ids), torch.from_numpy(mask))
    assert rel_err(to_np(h), np.asarray(out.last_hidden_state)) < TOL
    assert rel_err(to_np(pooled), np.asarray(out.pooler_output)) < TOL
    want = np.asarray(_try_clap_film(towers)(PROMPTS).class_labels)
    got = treg._try_clap_film(None, towers, "cpu")(PROMPTS).class_labels
    assert rel_err(to_np(got), want) < TOL


def _jax_params_file(module, args, path):
    params = module.init(jax.random.PRNGKey(4), *args)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * jax.random.normal(
        jax.random.PRNGKey(5), a.shape), params)
    with open(path, "wb") as f:
        f.write(fser.to_bytes(params))
    return params


def test_gpt2_generation_matches_jax(tmp_path):
    """GPT-2 on embeddings with a padded prompt: the JAX fixed-buffer scan
    and the port's appending loop give the same 8 vectors."""
    cfg = jcond.GPT2Config(n_embd=24, n_layer=2, n_head=2, n_positions=64)
    jgpt2 = jcond.GPT2Model(cfg)
    path = str(tmp_path / "gpt2.msgpack")
    params = _jax_params_file(jgpt2, (jnp.ones((1, 4, 24)), jnp.ones((1, 4))), path)
    r = np.random.default_rng(6)
    emb = r.standard_normal((3, 7, 24)).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3, [1] * 2 + [0] * 5], np.int32)
    want = np.asarray(jcond.generate_language_model(jgpt2, params, jnp.asarray(emb),
                                                    jnp.asarray(mask)))
    with torch.device("meta"):
        gpt2 = tcond.GPT2Model(GPT2Config(n_embd=24, n_layer=2, n_head=2, n_positions=64))
    treg.load_params_(gpt2, path)
    got = tcond.generate_language_model(gpt2, torch.from_numpy(emb), torch.from_numpy(mask))
    assert got.shape == (3, 8, 24)
    assert rel_err(to_np(got), want) < TOL


def test_projection_matches_jax(tmp_path):
    """SOS in front, EOS at each row's own length + 1, zeros past it."""
    cfg = jcond.AudioLDM2ProjectionConfig(text_encoder_dim=16, text_encoder_1_dim=40,
                                          langauge_model_dim=24)
    jproj = jcond.AudioLDM2ProjectionModel(cfg)
    path = str(tmp_path / "projection_lm.msgpack")
    params = _jax_params_file(jproj, (jnp.ones((1, 1, 16)), jnp.ones((1, 4, 40))), path)
    r = np.random.default_rng(7)
    hs, hs1 = (r.standard_normal(s).astype(np.float32) for s in ((3, 1, 16), (3, 6, 40)))
    m1 = np.array([[1] * 6, [1] * 3 + [0] * 3, [1] + [0] * 5], np.int32)
    want = jproj.apply(params, jnp.asarray(hs), jnp.asarray(hs1), jnp.ones((3, 1), jnp.int32),
                       jnp.asarray(m1))
    with torch.device("meta"):
        proj = tcond.AudioLDM2ProjectionModel(AudioLDM2ProjectionConfig(16, 40, 24))
    treg.load_params_(proj, path)
    got = proj(torch.from_numpy(hs), torch.from_numpy(hs1), torch.ones((3, 1), dtype=torch.int32),
               torch.from_numpy(m1))
    assert rel_err(to_np(got[0]), np.asarray(want[0])) < TOL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
