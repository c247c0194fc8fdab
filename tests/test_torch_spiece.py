"""T5 tokenizers with only a sentencepiece ``spiece.model``
(models/tokenizers.py: ``read_sentencepiece``, ``t5_tokenizer_json``,
``Tokenizer.from_dir``, ``export_tokenizer``) against transformers'
``T5Converter`` on the CPU.

The ``spiece.model`` files are written with transformers' own protobuf
module (``convert_slow_tokenizer.import_protobuf``): Unigram models over the
words and pieces of the MedleyMDPrompts captions, one with a Darts
precompiled charsmap (tests/test_torch_text_towers.py::_darts) and one with
``name: identity`` and no charsmap, a user-defined piece, under the
``legacy`` and ``add_prefix_space`` settings and ``extra_ids`` counts of a
``tokenizer_config.json``. The reference is ``T5Converter`` handed the
settings the slow ``T5Tokenizer`` resolves (no sentencepiece package is
needed for it), wrapped as ``T5TokenizerFast(tokenizer_object=...)`` so that
the extra ids are special tokens. Ids and attention masks must be equal on
every caption, on runs of spaces, on characters the charsmap maps, on
``<extra_id_3>`` inside text, and at ``max_length`` padding and truncation;
the exported ``tokenizer.json`` reads back to the same ids, in the port and
in ``AutoTokenizer``."""

import csv
import json
import os
from collections import Counter

import numpy as np
import pytest
from transformers import AutoTokenizer, T5TokenizerFast
from transformers.convert_slow_tokenizer import T5Converter, import_protobuf

from audioeditingcode_tpu_torch.models import tokenizers as tk
from test_torch_helpers import PORT_DIR
from test_torch_text_towers import _darts

CHARSMAP = {"ﬁ": "fi", "ｗ": "w", "ｉ": "i", "ｄ": "d", "ｅ": "e", "é": "é", "ｅ́": "é",
            "½": "1/2", "\t": " ", "　": " ", "Ａ": "A"}


def _captions():
    d = os.path.join(PORT_DIR, "data", "MedleyMDPrompts")
    out = []
    for name, col in (("captions_sources.csv", "source_captions"),
                      ("captions_targets.csv", "target_captions")):
        with open(os.path.join(d, name), newline="", encoding="utf-8") as f:
            out += [row[col] for row in csv.DictReader(f)]
    return out


CAPTIONS = _captions()
EXTRA_TEXTS = ["", " ", "a  recording   of    a song", "  leading and trailing  ",
               "tabs\tand　wide ｗｉｄｅ ﬁne Ａ café ｅ́ ½", "before <extra_id_3> after",
               "<extra_id_3>start", "end<extra_id_0>", "a <extra_id_99> b <extra_id_1>",
               "unknown ☃ symbols ✓ here", "</s> inside <pad> text <unk>", "[MASK] piece",
               "x" * 200]


def write_spiece(path, charsmap=True, model_type=1, byte_fallback=False, seed=0):
    """A Unigram spiece.model over the captions' words and pieces, seeded
    scores; control <pad> </s>, unknown <unk>, a user-defined [MASK]."""
    pb = import_protobuf()
    m = pb.ModelProto()
    rng = np.random.default_rng(seed)
    words = Counter(w for c in CAPTIONS for w in c.split())
    chars = sorted({ch for c in CAPTIONS for ch in c if not ch.isspace()} | set("fi1/2éwide"))
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("[MASK]", 0.0, 4),
              ("▁", -2.5, 1)]
    pieces += [("▁" + w, -float(rng.uniform(3, 9)), 1) for w, n in words.most_common(300)]
    subs = Counter(w[i:i + k] for w in words for k in (2, 3) for i in range(len(w) - k + 1))
    pieces += [(p, -float(rng.uniform(6, 11)), 1) for p, _ in subs.most_common(300)]
    pieces += [(ch, -float(rng.uniform(11, 13)), 1) for ch in chars]
    seen = set()
    for p, score, t in pieces:
        if p in seen:
            continue
        seen.add(p)
        x = m.pieces.add()
        x.piece, x.score, x.type = p, score, t
    m.trainer_spec.model_type = model_type
    m.trainer_spec.unk_id = 2
    m.trainer_spec.byte_fallback = byte_fallback
    if charsmap:
        m.normalizer_spec.name = "nmt_nfkc"
        m.normalizer_spec.precompiled_charsmap = _darts(CHARSMAP)
    else:
        m.normalizer_spec.name = "identity"
        m.normalizer_spec.add_dummy_prefix = True
        m.normalizer_spec.remove_extra_whitespaces = False
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    return m


def make_dir(d, config, **kw):
    os.makedirs(d, exist_ok=True)
    proto = write_spiece(os.path.join(d, "spiece.model"), **kw)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    return proto


def reference(d, proto, config):
    """T5TokenizerFast as from_pretrained(d) builds it from the slow
    tokenizer: T5Converter with the settings T5Tokenizer resolves."""
    extra_ids = config.get("extra_ids", 100)
    pieces = [p.piece for p in proto.pieces]

    class Slow:
        vocab_file = os.path.join(d, "spiece.model")
        _extra_ids = extra_ids
        legacy = True if config.get("legacy") is None else config["legacy"]
        add_prefix_space = config.get("add_prefix_space", True)

        def convert_tokens_to_ids(self, token):
            return pieces.index(token)

    return T5TokenizerFast(tokenizer_object=T5Converter(Slow()).converted(),
                           extra_ids=extra_ids,
                           model_max_length=config.get("model_max_length", 512))


CONFIGS = {
    "defaults": ({"model_max_length": 512}, {}),
    "legacy_false": ({"legacy": False, "extra_ids": 100}, {}),
    "no_prefix_space": ({"legacy": True, "add_prefix_space": False}, {}),
    "few_extra_ids": ({"extra_ids": 5, "legacy": False, "add_prefix_space": True}, {}),
    "identity": ({}, {"charsmap": False}),
    "identity_legacy_false": ({"legacy": False}, {"charsmap": False}),
}


def _same(port, ref, texts, **kw):
    ids, mask = port(texts, **kw)
    want = ref(texts, truncation=True, return_tensors="np", **kw)
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_spiece_only_folder_tokenizes_as_t5_converter(tmp_path, case):
    config, kw = CONFIGS[case]
    proto = make_dir(str(tmp_path / "tok"), config, **kw)
    ref = reference(str(tmp_path / "tok"), proto, config)
    port = tk.Tokenizer.from_dir(str(tmp_path / "tok"))
    texts = CAPTIONS + EXTRA_TEXTS
    for i, text in enumerate(texts):  # one by one first: the failing text by name
        ids = port.encode(text) + port.after
        assert ids == ref(text)["input_ids"], (i, text)
    _same(port, ref, texts, padding=True, max_length=512)
    _same(port, ref, texts, padding="max_length", max_length=16)
    _same(port, ref, texts[:50], padding="max_length", max_length=512)
    spec = tk.t5_tokenizer_json(str(tmp_path / "tok"))
    ref_spec = json.loads(ref.backend_tokenizer.to_str())
    for key in ("normalizer", "pre_tokenizer", "post_processor"):
        assert spec[key] == ref_spec[key], key
    assert spec["model"] == {**ref_spec["model"], "vocab": spec["model"]["vocab"]}
    # the scores are float32 values; the crate's JSON prints their f64 to
    # within one ulp of the double
    assert [p for p, _ in ref_spec["model"]["vocab"]] == [p for p, _ in spec["model"]["vocab"]]
    np.testing.assert_array_equal(np.float32([s for _, s in ref_spec["model"]["vocab"]]),
                                  np.float32([s for _, s in spec["model"]["vocab"]]))
    assert ({t["content"]: (t["id"], t["special"]) for t in spec["added_tokens"]}
            == {t["content"]: (t["id"], t["special"]) for t in ref_spec["added_tokens"]})


@pytest.mark.parametrize("case", ["defaults", "legacy_false", "identity"])
def test_export_writes_a_tokenizer_json_both_packages_read(tmp_path, case):
    config, kw = CONFIGS[case]
    src = str(tmp_path / "tok")
    proto = make_dir(src, config, **kw)
    out = str(tmp_path / "out")
    tk.export_tokenizer(src, out, "t5")
    assert sorted(os.listdir(out)) == ["tokenizer.json", "tokenizer_config.json"]
    with open(os.path.join(out, "tokenizer_config.json")) as f:
        written = json.load(f)
    assert "add_prefix_space" not in written and written["tokenizer_class"] == "T5Tokenizer"
    ref = reference(src, proto, config)
    texts = CAPTIONS[::7] + EXTRA_TEXTS
    _same(tk.Tokenizer.from_dir(out), ref, texts, padding="max_length", max_length=24)
    auto = AutoTokenizer.from_pretrained(out)
    got = auto(texts, padding="max_length", max_length=24, truncation=True,
               return_tensors="np")
    want = ref(texts, padding="max_length", max_length=24, truncation=True,
               return_tensors="np")
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


def test_reader_matches_protobuf(tmp_path):
    path = str(tmp_path / "spiece.model")
    proto = write_spiece(path)
    got = tk.read_sentencepiece(path)
    assert got["pieces"] == [(p.piece, p.score, p.type) for p in proto.pieces]
    assert got["model_type"] == 1 and got["unk_id"] == 2 and got["byte_fallback"] is False
    assert got["name"] == "nmt_nfkc"
    assert got["precompiled_charsmap"] == proto.normalizer_spec.precompiled_charsmap
    assert got["add_dummy_prefix"] and got["remove_extra_whitespaces"]
    assert got["escape_whitespaces"]
    pb = import_protobuf()
    m = pb.ModelProto()
    m.CopyFrom(proto)
    m.trainer_spec.unk_id = -1  # a negative int32: ten varint bytes
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = False
    m.normalizer_spec.escape_whitespaces = False
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    got = tk.read_sentencepiece(path)
    assert got["unk_id"] == -1 and got["name"] == "identity"
    assert not got["add_dummy_prefix"] and not got["escape_whitespaces"]


@pytest.mark.parametrize("kw,match", [({"model_type": 2}, "sentencepiece BPE"),
                                      ({"byte_fallback": True}, "byte_fallback")])
def test_bpe_models_and_byte_fallback_raise(tmp_path, kw, match):
    make_dir(str(tmp_path), {}, **kw)
    with pytest.raises(NotImplementedError, match=match):
        tk.Tokenizer.from_dir(str(tmp_path))


def test_corrupt_spiece_raises(tmp_path):
    path = tmp_path / "spiece.model"
    write_spiece(str(path))
    path.write_bytes(path.read_bytes()[:-7])
    with pytest.raises(ValueError, match="truncated"):
        tk.read_sentencepiece(str(path))
    with pytest.raises(ValueError, match="spiece.model does not read"):
        tk.export_tokenizer(str(tmp_path), str(tmp_path / "out"), "t5")
    path.write_bytes(b"\x08\x01")  # a piece field (1) written as a varint
    with pytest.raises(ValueError, match="wrong wire type"):
        tk.read_sentencepiece(str(path))
