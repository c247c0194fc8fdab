"""The port's checkpoint converter (cli/convert_checkpoint.py,
models/convert.py) against the JAX package's (tools/convert_checkpoint.py)
on the CPU.

Both converters run on one fake diffusers/transformers checkpoint of each
tiny model (test_torch_helpers.build_source_checkpoint; AudioLDM2 also
with a full ClapModel as its text encoder). Then: every ``.msgpack`` is the
same tree leaf for leaf and bit for bit (read back with flax's
``msgpack_restore``; the order of the keys in the file may differ), every
text tower's ``flax_model.msgpack`` and ``text_projection.npz`` too; the
port's tokenizer gives the ids and masks of transformers' AutoTokenizer on
the source; each package loads the other's directory to the same weights
and text conditioning. Tolerance: none, all comparisons are exact."""

import os

import numpy as np
import pytest
import torch
from flax import serialization as fser
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu_torch.cli.convert_checkpoint import convert as port_convert
from audioeditingcode_tpu_torch.models import convert as cv
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.tokenizers import Tokenizer, export_tokenizer
from test_torch_helpers import build_source_checkpoint

CASES = ["test/tiny-audioldm", "test/tiny-audioldm2", "test/tiny-audioldm2+ClapModel",
         "test/tiny-tango", "test/tiny-stable-audio", "test/tiny-sd", "test/tiny-celebahq"]
PROMPTS = ["a trumpet", "", "Hello, World!  It's 2024 --  café   naïve, don't",
           "  leading and trailing  ", "tab\there\nnew line", "日本語 ١٢٣ ½ ﬁne ｗｉｄｅ",
           "ｅ́ é é", "x" * 40, "the quick brown fox jumps over the lazy dog " * 3]
TOWER_DIRS = ("t5", "clap_text", "clip")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """case -> (source dir, the JAX tool's weights_dir, the port's)."""
    from tools.convert_checkpoint import convert as jax_convert

    cache = {}

    def get(case):
        if case not in cache:
            model_id, _, variant = case.partition("+")
            root = tmp_path_factory.mktemp(case.replace("/", "_").replace("+", "_"))
            src = build_source_checkpoint(model_id, str(root / "src"),
                                          clap_model=variant == "ClapModel", weight_norm=True)
            jax_convert(model_id, src, str(root / "jax"))
            port_convert(model_id, src, str(root / "port"))
            cache[case] = (src, str(root / "jax"), str(root / "port"))
        return cache[case]
    return get


def _tree(path):
    with open(path, "rb") as f:
        return flatten_dict(fser.msgpack_restore(f.read()))


def _assert_trees_bit_equal(got_path, want_path):
    got, want = _tree(got_path), _tree(want_path)
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:8]
    for k, w in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        assert np.asarray(g).shape == np.asarray(w).shape, k
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), k


@pytest.mark.parametrize("case", CASES)
def test_msgpack_files_are_the_same_trees(converted, case):
    _, jdir, pdir = converted(case)
    files = [f for f in os.listdir(jdir) if f.endswith(".msgpack")]
    assert files and sorted(files) == sorted(f for f in os.listdir(pdir) if f.endswith(".msgpack"))
    for f in files:
        _assert_trees_bit_equal(os.path.join(pdir, f), os.path.join(jdir, f))


@pytest.mark.parametrize("case", CASES)
def test_text_towers_are_bit_equal(converted, case):
    _, jdir, pdir = converted(case)
    towers = [t for t in TOWER_DIRS if os.path.isdir(os.path.join(jdir, t))]
    assert towers == [t for t in TOWER_DIRS if os.path.isdir(os.path.join(pdir, t))]
    if case.endswith("celebahq"):
        assert not towers
    for t in towers:
        _assert_trees_bit_equal(os.path.join(pdir, t, "flax_model.msgpack"),
                                os.path.join(jdir, t, "flax_model.msgpack"))
        if t == "clap_text":
            with np.load(os.path.join(pdir, t, "text_projection.npz")) as got, \
                    np.load(os.path.join(jdir, t, "text_projection.npz")) as want:
                assert sorted(got.files) == sorted(want.files) == ["b1", "b2", "w1", "w2"]
                for k in want.files:
                    assert got[k].dtype == want[k].dtype
                    assert got[k].tobytes() == want[k].tobytes(), k


def _tokenizer_pairs(src, case):
    """(source tokenizer dir, weights_dir tower) of each tower of a case."""
    if case.startswith("test/tiny-audioldm2"):
        return [("tokenizer_2", "t5"), ("tokenizer", "clap_text")]
    return {"test/tiny-audioldm": [("tokenizer", "clap_text")],
            "test/tiny-tango": [("tokenizer", "t5")],
            "test/tiny-stable-audio": [("tokenizer", "t5")],
            "test/tiny-sd": [("tokenizer", "clip")]}.get(case, [])


@pytest.mark.parametrize("case", [c for c in CASES if not c.endswith("celebahq")])
def test_tokenizers_agree_with_autotokenizer_on_the_source(converted, case):
    """The port's Tokenizer from the port's and from the JAX tool's
    directory, and transformers' AutoTokenizer on the source tokenizer
    (vocab.json + merges.txt for RoBERTa and CLIP, tokenizer.json for T5):
    equal ids and masks, padded to the longest and to max_length, and cut
    to a max_length shorter than some prompts."""
    from transformers import AutoTokenizer

    src, jdir, pdir = converted(case)
    for tok_sub, tower in _tokenizer_pairs(src, case):
        ref = AutoTokenizer.from_pretrained(os.path.join(src, tok_sub))
        mine, theirs = (Tokenizer.from_dir(os.path.join(d, tower)) for d in (pdir, jdir))
        assert mine.model_max_length == theirs.model_max_length == ref.model_max_length
        for padding in ("max_length", True):
            for max_length in (None, 6):
                kw = {} if max_length is None else {"max_length": max_length}
                want = ref(PROMPTS, padding=padding, truncation=True, return_tensors="np", **kw)
                for tok in (mine, theirs):
                    ids, mask = tok(PROMPTS, padding=padding, **kw)
                    np.testing.assert_array_equal(ids, want["input_ids"])
                    np.testing.assert_array_equal(mask, want["attention_mask"])


def _modules(pipe):
    if hasattr(pipe, "dit"):
        return {"dit": pipe.dit, "vae": pipe.vae, "projection": pipe.projection}
    mods = {"unet": pipe.unet, "vae": pipe.vae, "vocoder": pipe.vocoder}
    enc = pipe.text_encoder
    for name in ("gpt2", "projection"):
        if hasattr(enc, name):
            mods["text_" + name] = getattr(enc, name)
    return {k: m for k, m in mods.items() if m is not None}


@pytest.mark.parametrize("case", CASES)
def test_port_loads_its_directory_as_the_jax_one(converted, case):
    """load_model of the port from the port's weights_dir and from the JAX
    tool's: the same state dicts, and the same text conditioning."""
    model_id = case.partition("+")[0]
    _, jdir, pdir = converted(case)
    a, b = (treg.load_model(model_id, 4, device="cpu", weights_dir=d) for d in (pdir, jdir))
    ma, mb = _modules(a), _modules(b)
    assert set(ma) == set(mb)
    for name in ma:
        sa, sb = ma[name].state_dict(), mb[name].state_dict()
        assert set(sa) == set(sb), name
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    ca, cb = a.encode_text(PROMPTS[:3]), b.encode_text(PROMPTS[:3])
    for f in ("hidden_states", "class_labels", "attention_mask", "hidden_states_1",
              "attention_mask_1"):
        x, y = getattr(ca, f), getattr(cb, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


@pytest.mark.parametrize("case", CASES)
def test_jax_loads_the_port_directory(converted, case):
    """The JAX package's load_model from the port's weights_dir: the params
    and the text conditioning it gets from the JAX tool's directory."""
    from audioeditingcode_tpu.models.registry import load_model as jload

    model_id = case.partition("+")[0]
    _, jdir, pdir = converted(case)
    a, b = (jload(model_id, 4, weights_dir=d) for d in (pdir, jdir))
    parts = (("dit_params", "vae_params", "projection_params") if hasattr(a, "dit_params")
             else ("unet_params", "vae_params", "vocoder_params"))
    for part in parts:
        pa, pb = getattr(a, part), getattr(b, part)
        if pa is None:
            assert pb is None
            continue
        fa, fb = flatten_dict(pa), flatten_dict(pb)
        assert set(fa) == set(fb), part
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))
    if case.endswith("celebahq"):
        return
    ca, cb = a.encode_text(PROMPTS[:3]), b.encode_text(PROMPTS[:3])
    for f in ("hidden_states", "class_labels", "attention_mask", "hidden_states_1",
              "attention_mask_1"):
        x, y = getattr(ca, f), getattr(cb, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_fold_weight_norm_is_bit_equal_to_the_jax_fold(layout):
    from audioeditingcode_tpu.models.convert import fold_weight_norm as jfold

    r = np.random.RandomState(3)
    names = {"weight_g": ("weight_g", "weight_v"),
             "parametrizations": ("parametrizations.weight.original0",
                                  "parametrizations.weight.original1")}[layout]
    sd = {}
    for base, shape in (("conv_pre", (32, 17, 7)), ("ups.0", (16, 8, 4)),
                        ("resblocks.1.convs1.2", (8, 8, 3)), ("tiny", (3, 1, 1))):
        sd[f"{base}.{names[0]}"] = (r.rand(shape[0], 1, 1) + 0.5).astype(np.float32)
        sd[f"{base}.{names[1]}"] = r.randn(*shape).astype(np.float32)
    sd["conv_pre.bias"] = r.randn(32).astype(np.float32)
    sd["zero.weight_g"] = np.ones((2, 1, 1), np.float32)  # a zero v: the 1e-12 floor
    sd["zero.weight_v"] = np.zeros((2, 3, 3), np.float32)
    want = jfold(sd)
    got = cv.fold_weight_norm({k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype
        assert got[k].numpy().tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def vocoder_sd():
    """The tiny AudioLDM vocoder's state dict, as transformers names it."""
    from test_torch_helpers import checkpoint_state_dict, jax_tiny_pipeline

    params = jax_tiny_pipeline(4).vocoder_params["params"]
    return {k: torch.from_numpy(v) for k, v in checkpoint_state_dict(
        "test/tiny-audioldm", "vocoder", params, lambda x: x).items()}


def test_missing_tensor_raises_and_names_it(vocoder_sd):
    spec = treg.resolve_spec("test/tiny-audioldm")
    sd = dict(vocoder_sd)
    del sd["conv_post.weight"]
    with pytest.raises(cv.ConversionError, match=r"vocoder-dir.*conv_post\.weight"):
        cv.convert_part(spec, "vocoder", sd, where="vocoder-dir")


def test_left_over_tensor_raises_and_names_it_and_its_file(vocoder_sd):
    spec = treg.resolve_spec("test/tiny-audioldm")
    sd = dict(vocoder_sd, **{"conv_post.extra": torch.zeros(3)})
    with pytest.raises(cv.ConversionError, match=r"conv_post\.extra.*shard-2\.safetensors"):
        cv.convert_part(spec, "vocoder", sd, files={"conv_post.extra": "shard-2.safetensors"})


def test_wrong_shape_raises_and_names_it(vocoder_sd):
    spec = treg.resolve_spec("test/tiny-audioldm")
    sd = dict(vocoder_sd)
    sd["conv_post.bias"] = torch.zeros(2)
    with pytest.raises(cv.ConversionError, match=r"conv_post\.bias.*has shape \(2,\)"):
        cv.convert_part(spec, "vocoder", sd, files={"conv_post.bias": "v.bin"})


def test_vocoder_statistics_are_dropped_and_the_fold_applies(vocoder_sd):
    """mean/scale are dropped by name (normalize_before is False); a
    weight-normed conv in the parametrizations layout is folded."""
    spec = treg.resolve_spec("test/tiny-audioldm")
    w = vocoder_sd["conv_post.weight"]
    g = torch.linalg.vector_norm(w, dim=(1, 2), keepdim=True)
    sd = {k: v for k, v in vocoder_sd.items() if k != "conv_post.weight"}
    sd["conv_post.parametrizations.weight.original0"] = g
    sd["conv_post.parametrizations.weight.original1"] = w * 3.0
    sd["mean"], sd["scale"] = torch.zeros(8), torch.ones(8)
    mod = cv.convert_part(spec, "vocoder", sd)
    torch.testing.assert_close(mod.conv_post.weight, w, rtol=1e-6, atol=1e-7)


def test_deprecated_attention_names_map_as_diffusers_maps_them():
    """A VAE whose mid-block attention uses diffusers' old names (query,
    key, value, proj_attn) converts to the tensors of the new names."""
    spec = treg.resolve_spec("test/tiny-audioldm")
    with torch.device("meta"):
        keys = treg.AutoencoderKL(spec.vae).state_dict()
    g = torch.Generator().manual_seed(0)
    new = {k: torch.randn(v.shape, generator=g) for k, v in keys.items()}
    old = {k.replace("to_q.", "query.").replace("to_k.", "key.").replace("to_v.", "value.")
           .replace("to_out.0.", "proj_attn."): v for k, v in new.items()}
    assert old.keys() != new.keys()
    got = cv.convert_part(spec, "vae", old).state_dict()
    assert all(torch.equal(got[k], new[k]) for k in new)


def test_t5_tokenizer_without_tokenizer_json_raises(tmp_path):
    (tmp_path / "spiece.model").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="no tokenizer.json"):
        export_tokenizer(str(tmp_path), str(tmp_path / "out"), "t5")


def test_absent_text_encoder_is_skipped_present_but_broken_raises(converted, tmp_path, capsys):
    """No text_encoder/: one line and the rest converts; a text_encoder/
    that does not convert raises (the JAX tool prints "skipped")."""
    import shutil

    src, _, _ = converted("test/tiny-tango")
    bare = tmp_path / "bare"
    for sub in ("unet", "vae", "vocoder"):
        shutil.copytree(os.path.join(src, sub), bare / sub)
    stats = port_convert("test/tiny-tango", str(bare), str(tmp_path / "out"))
    assert "t5" not in stats and "t5 skipped" in capsys.readouterr().out
    shutil.copytree(os.path.join(src, "text_encoder"), bare / "text_encoder")
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        port_convert("test/tiny-tango", str(bare), str(tmp_path / "out2"))
