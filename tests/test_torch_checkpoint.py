"""Checkpoint files in the port: flax's msgpack format read and written in
pure Python (models/flax_msgpack.py), the bridge's Flax nesting
(models/bridge.py::torch_to_flax_tree), files the port writes read by the
JAX package, and strict loads of AudioLDM2's language-model manifests.

Every comparison here is bit-equality."""

import os

import flax.serialization as fser
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu.models.registry import load_model as jload
from audioeditingcode_tpu_torch.models import flax_msgpack as fm
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.audioldm2_cond import (
    AudioLDM2ProjectionModel,
    GPT2Model,
)
from audioeditingcode_tpu_torch.models.bridge import (
    flax_to_torch_state_dict,
    torch_to_flax_tree,
)
from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS, AudioLDM2ProjectionConfig, \
    GPT2Config
from test_torch_helpers import REPO, build_converted_checkpoint

TINY = ["test/tiny-audioldm", "test/tiny-audioldm2", "test/tiny-tango", "test/tiny-stable-audio"]
AUDIOLDM2 = ["cvssp/audioldm2", "cvssp/audioldm2-large", "cvssp/audioldm2-music"]


def _leaf_np(v):
    """A leaf as numpy: bfloat16 (a torch tensor in the port, a jnp dtype in
    flax) by its bits."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.uint16).numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_trees_equal(got, want):
    got, want = flatten_dict(got), flatten_dict(want)
    assert set(got) == set(want)
    for k in want:
        a, b = _leaf_np(got[k]), _leaf_np(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    return build_converted_checkpoint("test/tiny-audioldm",
                                      str(tmp_path_factory.mktemp("ckpt")))


@pytest.mark.parametrize("name", ["unet.msgpack", "vae.msgpack", "vocoder.msgpack",
                                  "clap_text/flax_model.msgpack"])
def test_reader_matches_flax_on_converted_files(converted, name):
    path = os.path.join(converted, name)
    with open(path, "rb") as f:
        want = fser.msgpack_restore(f.read())
    _assert_trees_equal(fm.read_file(path), want)


def _odd_tree():
    r = np.random.default_rng(0)
    return {"params": {
        "w": r.standard_normal((3, 5)).astype(np.float32),
        "bf": jnp.asarray(r.standard_normal((4, 7)), jnp.bfloat16),
        "big": r.standard_normal((33,)).astype(np.float32),
        "half": r.standard_normal((2, 3)).astype(np.float16),
        "ints": np.arange(300, dtype=np.int64) - 150,
        "empty": np.zeros((0, 4), np.float32),
        "scalars": {"f": np.float32(2.5), "i": np.int32(-7), "b": np.bool_(True)},
        "py": {"int": -100000, "float": 0.125, "str": "x" * 40, "none": None,
               "true": True, "huge": 2 ** 40},
    }}


@pytest.mark.parametrize("chunk", [None, 64])
def test_reader_and_writer_match_flax_bytes(monkeypatch, tmp_path, chunk):
    """bf16 arrays, numpy scalars and Python leaves; with ``chunk`` the
    arrays over that many bytes become flax's chunked dicts (flax's
    MAX_CHUNK_SIZE patched small, and the port's with it)."""
    if chunk is not None:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    tree = _odd_tree()
    want = fser.msgpack_serialize(tree)
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in want
    got = fm.msgpack_restore(want)
    _assert_trees_equal(got, fser.msgpack_restore(want))
    path = str(tmp_path / "tree.msgpack")
    assert fm.write_file(got, path) == len(want)
    with open(path, "rb") as f:
        assert f.read() == want


def test_reader_rejects_complex_and_garbage():
    with pytest.raises(ValueError, match="ext type 2"):
        fm.msgpack_restore(fser.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated"):
        fm.msgpack_restore(fser.msgpack_serialize({"w": np.ones(8, np.float32)})[:-3])


@pytest.mark.parametrize("part", ["unet", "vae", "vocoder"])
def test_port_file_reads_back_through_flax(converted, tmp_path, part):
    """A converted file loaded by the port and written back by save_params
    is the converted file, leaf for leaf, as flax reads it."""
    pipe = treg.load_model("test/tiny-audioldm", 4, device="cpu", weights_dir=converted)
    path = str(tmp_path / f"{part}.msgpack")
    n = treg.save_params(getattr(pipe, part), path)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        got = fser.msgpack_restore(f.read())
    with open(os.path.join(converted, f"{part}.msgpack"), "rb") as f:
        want = fser.msgpack_restore(f.read())
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
def test_jax_load_model_accepts_port_files(tmp_path, model_id):
    """Seeded port modules written by save_params load in the JAX
    load_model(weights_dir=...), with the port's weights and the JAX
    init's tree."""
    pipe = treg.load_model(model_id, 4, device="cpu", seed=5)
    parts = ({"dit": "dit", "oobleck": "vae", "projection": "projection"}
             if model_id == "test/tiny-stable-audio"
             else {"unet": "unet", "vae": "vae", "vocoder": "vocoder"})
    for f, attr in parts.items():
        treg.save_params(getattr(pipe, attr), str(tmp_path / f"{f}.msgpack"))
    jpipe = jload(model_id, 4, weights_dir=str(tmp_path))
    fresh = jload(model_id, 4)
    for f, attr in parts.items():
        got = getattr(jpipe, attr + "_params")
        assert set(flatten_dict(got)) == set(flatten_dict(getattr(fresh, attr + "_params")))
        _assert_trees_equal(got, torch_to_flax_tree(getattr(pipe, attr)))


@pytest.mark.parametrize("model_id", TINY)
def test_bridge_writes_the_jax_nesting(model_id):
    """torch_to_flax_tree inverts flax_to_torch_state_dict on every module
    of the tiny models, JAX nesting included."""
    from test_torch_helpers import jax_tiny_pipeline

    jpipe = jax_tiny_pipeline(4, model_id)
    pipe = treg.load_model(model_id, 4, device="cpu")
    parts = ("dit", "vae", "projection") if hasattr(jpipe, "dit") else ("unet", "vae", "vocoder")
    for part in parts:
        params = getattr(jpipe, part + "_params")
        mod = getattr(pipe, part)
        mod.load_state_dict(flax_to_torch_state_dict(flatten_dict(params), mod))
        _assert_trees_equal(torch_to_flax_tree(mod), params)


def _manifest(model_id, name):
    path = os.path.join(REPO, "data", "key_manifests", model_id.replace("/", "__"), name)
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


# keys of the checkpoint the embeddings-in language model does not hold
# (the JAX converter drops them too: tools/convert_checkpoint.py::convert_gpt2)
UNUSED = {"language_model.txt": {"wte.weight"}, "projection_model.txt": set()}


@pytest.mark.parametrize("name", ["language_model.txt", "projection_model.txt"])
@pytest.mark.parametrize("model_id", AUDIOLDM2)
def test_language_model_manifests_load_strictly(model_id, name):
    spec = MODEL_SPECS[model_id]
    want = _manifest(model_id, name)
    assert UNUSED[name] <= set(want)
    with torch.device("meta"):
        mod = (GPT2Model(spec.gpt2 or GPT2Config()) if name == "language_model.txt"
               else AudioLDM2ProjectionModel(spec.projection_lm or AudioLDM2ProjectionConfig()))
    sd = {k: torch.empty(s, device="meta") for k, s in want.items() if k not in UNUSED[name]}
    mod.load_state_dict(sd, strict=True, assign=True)
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == \
        {k: s for k, s in want.items() if k not in UNUSED[name]}


def test_load_names_the_file_on_mismatch(converted, tmp_path):
    import shutil

    for f in ("unet.msgpack", "vae.msgpack", "vocoder.msgpack"):
        shutil.copy(os.path.join(converted, f), tmp_path / f)
    tree = fm.read_file(str(tmp_path / "vae.msgpack"))
    del tree["params"]["quant_conv"]
    fm.write_file(tree, str(tmp_path / "vae.msgpack"))
    with pytest.raises(ValueError, match="vae.msgpack"):
        treg.load_model("test/tiny-audioldm", 4, device="cpu", weights_dir=str(tmp_path))
    tree = fm.read_file(str(tmp_path / "vocoder.msgpack"))
    tree["params"]["stray"] = {"kernel": np.zeros(3, np.float32)}
    fm.write_file(tree, str(tmp_path / "vocoder.msgpack"))
    shutil.copy(os.path.join(converted, "vae.msgpack"), tmp_path / "vae.msgpack")
    with pytest.raises(ValueError, match="vocoder.msgpack.*no torch target"):
        treg.load_model("test/tiny-audioldm", 4, device="cpu", weights_dir=str(tmp_path))


def test_bfloat16_load_keeps_float32_params_exact(tmp_path):
    """In bfloat16 the params the Flax modules keep in float32 (the DiT's
    Fourier features, the duration embedding's weights, Snake's alpha and
    beta) hold the file's float32 values, not bf16-rounded ones."""
    pipe = treg.load_model("test/tiny-stable-audio", 4, device="cpu", seed=5)
    for f, attr in (("dit", "dit"), ("oobleck", "vae"), ("projection", "projection")):
        treg.save_params(getattr(pipe, attr), str(tmp_path / f"{f}.msgpack"))
    bf = treg.load_model("test/tiny-stable-audio", 4, device="cpu", dtype=torch.bfloat16,
                         weights_dir=str(tmp_path))
    checked = 0
    for attr in ("dit", "vae", "projection"):
        want = getattr(pipe, attr)
        for m_name, m in getattr(bf, attr).named_modules():
            for name in getattr(m, "float32_params", ()):
                got = m.get_parameter(name)
                ref = want.get_submodule(m_name).get_parameter(name)
                assert got.dtype == torch.float32 and torch.equal(got, ref), (attr, m_name)
                checked += 1
    assert checked and bf.dit.proj_in.weight.dtype == torch.bfloat16
