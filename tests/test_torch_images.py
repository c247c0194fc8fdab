"""The image path of the port against the JAX package on the CPU: the
image IO (utils/image_io.py, no PIL) against the JAX one (PIL), CLIP's
tokenizer against CLIPTokenizerFast, the CLIP text tower against
FlaxCLIPTextModel, the VQ autoencoder, the tiny SD and CelebA-HQ UNets,
SDEdit and PC editing on test/tiny-sd against the JAX functions on bridged
params with the JAX draws passed in, and the image CLIs end to end.

Tolerances: load_image within one uint8 step (2/255 in [-1, 1]) of the
JAX one (measured: equal); token ids and masks equal; the CLIP tower,
the VQ model and the UNet forwards 1e-4 relative (max abs error over max
abs value), VQ codes equal; the SDEdit loop 1e-3 (the eta-1 chain bound
of tests/test_torch_sdedit.py); PC extraction and application at ``-c
0.1`` with the bounds of tests/test_torch_pc_cli.py."""

import json
import os
import re
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audioeditingcode_tpu.cli import pc_apply as jpa
from audioeditingcode_tpu.cli import pc_extract as jpe
from audioeditingcode_tpu.editing import sdedit as jsd
from audioeditingcode_tpu.editing.pcdata import load_extraction as j_load
from audioeditingcode_tpu.models.registry import load_model as j_load_model
from audioeditingcode_tpu.utils import image_io as jio
from audioeditingcode_tpu_torch.cli import images as tcli
from audioeditingcode_tpu_torch.cli import pc_apply as tpa
from audioeditingcode_tpu_torch.cli import pc_extract as tpe
from audioeditingcode_tpu_torch.editing import sdedit as tsd
from audioeditingcode_tpu_torch.editing.pcdata import load_extraction as t_load
from audioeditingcode_tpu_torch.models import registry as treg
from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
from audioeditingcode_tpu_torch.models.text_encoders import load_text_tower
from audioeditingcode_tpu_torch.models.tokenizers import _BYTE_CHARS, Tokenizer
from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_helpers import PORT_DIR, rel_err, to_np

TOL = 1e-4
LOOP_TOL = 1e-3
STEPS = 6
IMAGE_IDS = ["CompVis/stable-diffusion-v1-4", "CompVis/ldm-celebahq-256", "test/tiny-sd",
             "test/tiny-celebahq"]


# ------------------------------------------------------------------ image IO
def _smooth(h, w, c, seed=0):
    """A smooth pattern plus noise: every PNG filter gets chosen by PIL."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)


def _write_pil(path, mode, h, w):
    from PIL import Image

    arr = _smooth(h, w, 4)
    im = Image.fromarray(arr[:, :, :3], "RGB")
    im = {"RGB": im, "RGBA": Image.fromarray(arr, "RGBA"), "L": im.convert("L"),
          "P": im.convert("P", palette=Image.ADAPTIVE, colors=200)}[mode]
    im.save(path)
    return path


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("hw,size", [((400, 600), (512, 512)), ((60, 40), (32, 32)),
                                     ((16, 16), (64, 64))],
                         ids=["downsample", "small_downsample", "upsample"])
def test_load_image_matches_pil(tmp_path, mode, hw, size):
    path = _write_pil(str(tmp_path / f"{mode}.png"), mode, *hw)
    want = jio.load_image(path, resize=size)
    got = tio.load_image(path, resize=size)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (1, 3) + size
    assert np.abs(got - want).max() <= 2.0 / 255 + 1e-6


def test_png_reader_matches_pil_convert(tmp_path):
    """The decoded pixels equal PIL's convert("RGB"), also for greyscale +
    alpha and a 4-bit palette."""
    from PIL import Image

    for name, im in (("la", Image.fromarray(_smooth(30, 20, 4), "RGBA").convert("LA")),
                     ("p4", Image.fromarray(_smooth(30, 20, 3)).convert(
                         "P", palette=Image.ADAPTIVE, colors=16))):
        path = str(tmp_path / f"{name}.png")
        im.save(path, **({"bits": 4} if name == "p4" else {}))
        np.testing.assert_array_equal(tio.read_png_rgb(path),
                                      np.asarray(Image.open(path).convert("RGB")))


def test_save_image_matches_jax(tmp_path):
    from PIL import Image

    x = np.random.default_rng(1).uniform(-1.2, 1.2, (1, 3, 20, 30)).astype(np.float32)
    jio.save_image(str(tmp_path / "jax.png"), x)
    tio.save_image(str(tmp_path / "port.png"), x)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    np.testing.assert_array_equal(tio.read_png_rgb(str(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_png_reader_names_what_it_does_not_take(tmp_path):
    """The PNG reader names the format of any other file; the 16-bit and
    1-bit greyscale PNGs it once refused now decode as PIL decodes them
    (tests/test_torch_image_formats.py holds every other case)."""
    from PIL import Image

    Image.fromarray(_smooth(8, 8, 3)).save(tmp_path / "a.jpg")
    with pytest.raises(ValueError, match="JPEG"):
        tio.read_png_rgb(str(tmp_path / "a.jpg"))
    Image.fromarray(_smooth(8, 8, 3)).save(tmp_path / "a.gif")
    with pytest.raises(ValueError, match="GIF"):
        tio.read_png_rgb(str(tmp_path / "a.gif"))
    Image.fromarray(_smooth(8, 8, 1)[:, :, 0].astype(np.uint16) * 257).save(
        tmp_path / "deep.png")
    Image.fromarray(_smooth(8, 8, 3)).convert("1").save(tmp_path / "bits.png")
    for name in ("deep.png", "bits.png"):
        np.testing.assert_array_equal(tio.read_png_rgb(str(tmp_path / name)), np.asarray(
            Image.open(tmp_path / name).convert("RGB")))
    # an interlace method other than 0 (none) and 1 (Adam7)
    tio.write_png(str(tmp_path / "i.png"), _smooth(8, 8, 3))
    data = bytearray(open(tmp_path / "i.png", "rb").read())
    data[28] = 2
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(tmp_path / "i.png", "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlace method 2"):
        tio.read_png_rgb(str(tmp_path / "i.png"))


# the one import allowed: the eval tower's transformers oracle
# (--clap_backend torch) imports transformers when it is built, never on the
# port's own paths
_ORACLE_IMPORT = (os.path.join("evals", "features.py"),
                  "            from transformers import AutoProcessor, ClapModel\n")


def test_port_imports_no_image_or_tokenizer_library():
    forbidden = re.compile(r"^\s*(import|from)\s+(PIL|regex|transformers|tokenizers)\b", re.M)
    for d, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    src = fh.read()
                if os.path.relpath(path, PORT_DIR) == _ORACLE_IMPORT[0]:
                    assert src.count(_ORACLE_IMPORT[1]) == 1
                    src = src.replace(_ORACLE_IMPORT[1], "")
                assert not forbidden.search(src), f


# ------------------------------------------------------------------ CLIP
def _rich_clip_tokenizer(d):
    """A CLIP vocabulary with every byte, its </w> form and merges for a
    few words (also across a non-ASCII letter)."""
    os.makedirs(d, exist_ok=True)
    vocab = {}
    for c in _BYTE_CHARS.values():
        vocab.setdefault(c, len(vocab))
    for c in list(_BYTE_CHARS.values()):
        vocab.setdefault(c + "</w>", len(vocab))
    merges = []
    for word in ("a", "photo", "of", "the", "cat", "dog", "sitting", "on", "red", "don",
                 "café"):
        syms = list("".join(_BYTE_CHARS[b] for b in word.encode()))
        syms[-1] += "</w>"
        while len(syms) > 1:
            if [syms[0], syms[1]] not in merges:
                merges.append([syms[0], syms[1]])
            vocab.setdefault(syms[0] + syms[1], len(vocab))
            syms = [syms[0] + syms[1]] + syms[2:]
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer", "model_max_length": 77}, f)


CLIP_PROMPTS = [
    "A Photo of THE Cat", "", "hello, world!!  It's 2024 -- don't", "a red dog sitting on it.",
    "  leading\tand\ntrailing  ", "café naïve ÉCOLE ΑΣ İstanbul", "日本語 ١٢٣ ½ ﬁne ｗｉｄｅ",
    "x'y ''s 'll 'RE", "<|startoftext|>a cat<|endoftext|> dog",
    "numbers 3.14159 and 1,000,000", " ".join(["the cat"] * 60), "é ｅ́ \x1c sep",
]


@pytest.fixture(scope="module")
def clip_tokenizers(tmp_path_factory):
    """The rich tokenizer and the converter tests' ASCII one, as
    AutoTokenizer.save_pretrained writes them (tokenizer.json)."""
    import test_convert_integration as tci
    from transformers import AutoTokenizer

    out = {}
    for name, make in (("rich", _rich_clip_tokenizer), ("ascii", tci.make_clip_tokenizer_dir)):
        root = tmp_path_factory.mktemp(f"clip_{name}")
        make(str(root / "src"))
        AutoTokenizer.from_pretrained(str(root / "src")).save_pretrained(str(root / "out"))
        out[name] = str(root / "out")
    return out


@pytest.mark.parametrize("name", ["rich", "ascii"])
def test_clip_tokens_match_fast_tokenizer(clip_tokenizers, name):
    from transformers import AutoTokenizer, CLIPTokenizerFast

    d = clip_tokenizers[name]
    ref, mine = AutoTokenizer.from_pretrained(d), Tokenizer.from_dir(d)
    assert isinstance(ref, CLIPTokenizerFast)
    for padding in ("max_length", True):
        want = ref(CLIP_PROMPTS, padding=padding, truncation=True, return_tensors="np")
        ids, mask = mine(CLIP_PROMPTS, padding=padding)
        np.testing.assert_array_equal(ids, want["input_ids"])
        np.testing.assert_array_equal(mask, want["attention_mask"])
    if name == "rich":  # the long prompt is cut to 77 with its end token
        assert len(mine.encode(CLIP_PROMPTS[10])) > 77 and ids.shape[1] == 77


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory, clip_tokenizers):
    """A tiny clip/ directory as tools/convert_checkpoint.py exports it:
    FlaxCLIPTextModel.save_pretrained plus the rich tokenizer."""
    import shutil

    from transformers import CLIPTextConfig, FlaxCLIPTextModel

    d = str(tmp_path_factory.mktemp("clip") / "clip")
    cfg = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, vocab_size=len(json.load(open(os.path.join(
                             clip_tokenizers["rich"], "vocab.json")))),
                         max_position_embeddings=77)
    model = FlaxCLIPTextModel(cfg, seed=3)
    params = jax.tree_util.tree_map(lambda p: p * 3.0, model.params)  # away from the init
    model.save_pretrained(d, params=params)
    for f in os.listdir(clip_tokenizers["rich"]):
        shutil.copy(os.path.join(clip_tokenizers["rich"], f), d)
    return d


def test_clip_text_model_matches_flax(clip_dir):
    from transformers import FlaxCLIPTextModel

    tok = Tokenizer.from_dir(clip_dir)
    ids, mask = tok(["a photo of the cat", "", "hello, world!! it's a red dog sitting"],
                    padding="max_length")
    want = np.asarray(FlaxCLIPTextModel.from_pretrained(clip_dir)(
        input_ids=ids, attention_mask=mask).last_hidden_state)
    got = to_np(load_text_tower(clip_dir)(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert got.shape == want.shape == (3, 77, 32)
    assert rel_err(got, want) <= TOL


def test_clip_encoder_matches_the_jax_registry(clip_dir):
    """The registry's CLIP conditioning from a weights_dir (the stream, no
    mask) against the JAX registry's ``_try_clip_encoder``."""
    from audioeditingcode_tpu.models import registry as jreg

    spec = treg.resolve_spec("test/tiny-sd")
    root = os.path.dirname(clip_dir)
    prompts = ["a red dog", "café ΑΣ 3.14"]
    want = jreg._try_clip_encoder(spec, root)(prompts)
    got = treg._make_text_encoder(spec, "cpu", root)(prompts)
    assert got.attention_mask is None and want.attention_mask is None
    assert rel_err(to_np(got.hidden_states), want.hidden_states) <= TOL


# ------------------------------------------------------------------ models
def _bridged(model_id, steps=STEPS):
    """(JAX pipeline, the port's with its params) for an image model."""
    jpipe = j_load_model(model_id, steps)
    pipe = treg.load_model(model_id, steps, device="cpu")
    for mod, params in ((pipe.unet, jpipe.unet_params), (pipe.vae, jpipe.vae_params)):
        mod.load_state_dict(flax_to_torch_state_dict(flatten_dict(params), mod))
    return jpipe, pipe


@pytest.fixture(scope="module")
def tiny_sd():
    return _bridged("test/tiny-sd")


@pytest.fixture(scope="module")
def tiny_celebahq():
    return _bridged("test/tiny-celebahq")


@pytest.mark.parametrize("model_id", IMAGE_IDS)
def test_image_ids_resolve_and_build(model_id):
    spec = treg.resolve_spec(model_id)
    assert spec.family in ("stable-diffusion", "celebahq") and spec.vocoder is None
    assert not hasattr(treg, "_NOT_PORTED")
    if model_id.startswith("test/"):
        pipe = treg.load_model(model_id, 4)
        vq = spec.vae.num_vq_embeddings > 0
        assert type(pipe.vae).__name__ == ("VQModel" if vq else "AutoencoderKL")
        assert pipe.vocoder is None and pipe.vae_pad_multiple == spec.vae.downscale_factor
        with pytest.raises(ValueError, match="no vocoder"):
            pipe.decode_to_mel(torch.zeros(1, 3, 8, 8))
        if vq:  # the Flax init U(0, 2 / N), kept in float32 in bfloat16
            cb = treg.load_model(model_id, 4, dtype=torch.bfloat16).vae.codebook
            assert cb.dtype == torch.float32 and 0 <= cb.min() and cb.max() < 2.0 / cb.shape[0]


def test_vq_model_matches_jax(tiny_celebahq):
    jpipe, pipe = tiny_celebahq
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    jz = np.asarray(jpipe.vae_encode(jnp.asarray(x)))
    z = pipe.vae_encode(torch.from_numpy(x))
    assert rel_err(to_np(z), jz) <= TOL
    vae, jvae, jparams = pipe.vae, jpipe.vae, jpipe.vae_params
    zn = jnp.transpose(jnp.asarray(jz), (0, 2, 3, 1))
    jq = np.asarray(jvae.apply(jparams, zn, method=jvae.quantize)).transpose(0, 3, 1, 2)
    q = to_np(vae.quantize(torch.from_numpy(jz)))
    np.testing.assert_array_equal(q, jq)  # the same codebook rows
    for force in (False, True):
        want = np.asarray(jvae.apply(jparams, zn, force, method=jvae.decode)).transpose(0, 3, 1, 2)
        got = to_np(vae.decode(torch.from_numpy(jz), force_not_quantize=force))
        assert rel_err(got, want) <= TOL, force


def test_vq_weights_in_the_converters_layout(tiny_celebahq, tmp_path):
    """The port writes the VQ model as tools/convert_checkpoint.py does
    (the codebook a top-level param, untransposed): the JAX package reads
    the file into its VQModel's tree, equal leaf for leaf."""
    from flax import serialization

    jpipe, pipe = tiny_celebahq
    path = str(tmp_path / "vae.msgpack")
    treg.save_params(pipe.vae, path)
    with open(path, "rb") as f:
        got = flatten_dict(serialization.from_bytes(jpipe.vae_params, f.read()))
    want = flatten_dict(jpipe.vae_params)
    assert got.keys() == want.keys() and ("params", "codebook") in got
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("model", ["tiny_sd", "tiny_celebahq"])
def test_cfg_unet_forward_matches_jax(request, model):
    """One CFG-batched denoiser forward through make_eps_pair: SD's
    cross-attention to the (null) text stream; CelebA-HQ's UNet with no
    attention, no mid block and no conditioning."""
    jpipe, pipe = request.getfixturevalue(model)
    C = pipe.unet.config.in_channels
    w = np.random.default_rng(3).standard_normal((1, C, 16, 16)).astype(np.float32)
    ju, jc = jpipe.make_eps_pair(jpipe.encode_text([""], negative=True),
                                 jpipe.encode_text(["a cat"]))(jnp.asarray(w), jnp.asarray(w), 2)
    tu, tc = pipe.make_eps_pair(pipe.encode_text([""], negative=True),
                                pipe.encode_text(["a cat"]))(torch.from_numpy(w),
                                                             torch.from_numpy(w), 2)
    assert rel_err(to_np(tu), ju) <= TOL and rel_err(to_np(tc), jc) <= TOL


def test_sdedit_loop_on_tiny_sd_matches_jax(tiny_sd):
    jpipe, pipe = tiny_sd
    x = tio.load_image(_smooth(40, 48, 3), resize=(32, 32))
    jw0 = jpipe.vae_encode(jnp.asarray(x))
    w0 = pipe.vae_encode(torch.from_numpy(x))
    skip, cfg = 2, 7.5
    want = np.asarray(jsd.sdedit_loop(
        jpipe.sched, jpipe.make_eps_pair(jpipe.encode_text([""], negative=True),
                                         jpipe.encode_text(["a red dog"])),
        jw0, jax.random.PRNGKey(9), skip=skip, cfg_tar=cfg))
    k_noise, k_lat = jax.random.split(jax.random.PRNGKey(9))
    noise = np.array(jax.random.normal(k_noise, w0.shape))
    latents = np.array(jax.random.normal(k_lat, (STEPS - skip,) + tuple(w0.shape)))
    got = to_np(tsd.sdedit_loop(
        pipe.sched, pipe.make_eps_pair(pipe.encode_text([""], negative=True),
                                       pipe.encode_text(["a red dog"])),
        w0, torch.from_numpy(noise), torch.from_numpy(latents), skip=skip, cfg_tar=cfg))
    assert rel_err(got, want) <= LOOP_TOL


# ------------------------------------------------------------------ PC editing
# (n_evs, patch): one PC over the whole latent, one under a four-value
# (top, bottom, left, right) latent patch
EXTRACTIONS = {"whole": (1, None), "patch": (1, (2, 12, 4, 14))}


def _pc_argv(init_im, patch):
    argv = ["--model_id", "test/tiny-sd", "--init_im", init_im, "--num_diffusion_steps",
            str(STEPS), "--drift_start", "4", "--drift_end", "2", "--iters", "21",
            "--n_evs", "1", "-c", "0.1", "--seed", "3", "--wandb_disable", "-r", "32", "32",
            "--source_prompt", "a face"]
    return argv + (["--patch"] + [str(p) for p in patch] if patch else [])


@pytest.fixture(scope="module")
def image_extractions(tiny_sd, tmp_path_factory):
    """Each extraction through both drivers from the image CLIs' args:
    (JAX npz, port npz)."""
    from audioeditingcode_tpu.cli import images as jimg

    jpipe, pipe = tiny_sd
    d = tmp_path_factory.mktemp("img")
    init_im = str(d / "face.png")
    tio.write_png(init_im, _smooth(40, 48, 3))
    w0 = jpipe.vae_encode(jnp.asarray(tio.load_image(init_im, resize=(32, 32))))
    out = {}
    for name, (n_evs, patch) in EXTRACTIONS.items():
        argv = _pc_argv(init_im, patch)
        args = {}
        for key, parser in (("jax", jimg.pc_extract_parser), ("port", tcli.pc_extract_parser)):
            a = parser().parse_args(argv + (["--device", "cpu"] if key == "port" else []))
            a.pc_mode, a.eta, a.numerical_fix = "both", 1.0, True
            args[key] = a
        key = jax.random.PRNGKey(5)
        jpath, _ = jpe.run_pc_extraction(args["jax"], jpipe, w0, key, 3.0, str(d), f"jax_{name}",
                                         3)
        key, r_inv = jax.random.split(key)
        inv = torch.from_numpy(np.array(jax.random.normal(r_inv, (STEPS,) + w0.shape)))
        v0s = []
        for _ in range(2):
            key, r_eig = jax.random.split(key)
            v0s.append(torch.from_numpy(np.array(jax.random.normal(r_eig, (1,) + w0.shape[1:]))))
        tpath, _ = tpe.run_pc_extraction(args["port"], pipe, torch.from_numpy(np.array(w0)),
                                         None, 3.0, str(d), f"port_{name}", 3, inv_noise=inv,
                                         v0s=v0s)
        out[name] = (jpath, tpath)
    return out


@pytest.mark.parametrize("name", list(EXTRACTIONS))
def test_image_pc_extraction_matches_jax(image_extractions, name):
    jpath, tpath = image_extractions[name]
    j, t = np.load(jpath), np.load(tpath)
    for f in ("latents", "xts", "norm_factors"):
        assert t[f].shape == j[f].shape and rel_err(t[f], j[f]) <= TOL, f
    cos = float((t["eig_vecs"].ravel().astype(np.float64) @ j["eig_vecs"].ravel())
                / np.linalg.norm(t["eig_vecs"]) / np.linalg.norm(j["eig_vecs"]))
    assert t["eig_vecs"].shape == j["eig_vecs"].shape and cos >= 0.9999
    assert rel_err(t["eig_vals"], j["eig_vals"]) <= 5e-4
    if name == "patch":  # nothing outside the patch
        vecs = t["eig_vecs"].reshape((2, 1) + j["latents"].shape[2:])
        outside = np.ones(vecs.shape, bool)
        outside[..., 2:12, 4:14] = False
        assert np.abs(vecs[outside]).max() == 0


@pytest.mark.parametrize("name,extra", [("whole", []),
                                        ("patch", ["--fix_alpha", "0.3"])])
def test_image_pc_application_matches_jax(tiny_sd, image_extractions, name, extra):
    jpipe, pipe = tiny_sd
    jpath = image_extractions[name][0]
    argv = ["--extraction_path", jpath, "--drift_start", "4", "--drift_end", "2",
            "--amount", "2", "--seed", "1", "--wandb_disable"] + extra
    outs = {}
    for key, cli, load, p, as_arr in (("jax", jpa, j_load, jpipe, jnp.asarray),
                                      ("port", tpa, t_load, pipe, torch.from_numpy)):
        args = cli.parse_args(argv)
        loaded = load(jpath[: -len(".npz")])
        xts = as_arr(loaded["xts"]) if args.fix_alpha is not None else None
        xt = cli.run_pc_application(args, p, loaded["args"], loaded["eigdata"],
                                    as_arr(loaded["latents"]), xts, 3.0,
                                    float(loaded["args"].eta))
        outs[key] = to_np(xt) if key == "port" else np.asarray(xt)
    want, got = outs["jax"], outs["port"]
    assert got.shape == want.shape and rel_err(got, want) <= LOOP_TOL
    assert rel_err(got, np.load(jpath)["xts"][-1]) > 1e-3  # the drift moved it


# ------------------------------------------------------------------ the CLIs
@pytest.fixture(scope="module")
def face(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("face") / "face.png")
    tio.write_png(path, _smooth(48, 64, 3))
    return path


@pytest.mark.parametrize("model_id", ["test/tiny-sd", "test/tiny-celebahq"])
def test_sdedit_cli_end_to_end_on_cpu(face, tmp_path, model_id):
    out = tcli.sdedit_main(["--device", "cpu", "--model_id", model_id, "--init_im", face,
                            "--target_prompt", "a cat", "--num_diffusion_steps", str(STEPS),
                            "--tstart", "4", "-r", "32", "32", "--seed", "0",
                            "--results_path", str(tmp_path)])
    assert os.path.basename(out) == "s0_skip2_cfg12.png"
    img, orig = tio.read_png_rgb(out), tio.read_png_rgb(os.path.join(os.path.dirname(out),
                                                                      "orig.png"))
    assert img.shape == orig.shape == (32, 32, 3) and not np.array_equal(img, orig)
    with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
        rec = json.load(f)
    assert rec["unet_steps"] == 4 and rec["device"] == "cpu"


def test_pc_clis_end_to_end_on_cpu(face, tmp_path):
    ckpt = tcli.pc_extract_main(["--device", "cpu", "--model_id", "test/tiny-sd", "--init_im",
                                 face, "--num_diffusion_steps", str(STEPS), "--drift_start",
                                 "4", "--drift_end", "2", "--iters", "3", "-r", "32", "32",
                                 "--seed", "0", "-c", "0.1", "--dtype", "bfloat16",
                                 "--results_path", str(tmp_path)])
    with open(os.path.join(os.path.dirname(ckpt), "run_args.json")) as f:
        rec = json.load(f)
    assert rec["dtype"] == "float32" and rec["window_steps"] == 2
    outs = {}
    for amount in ("0", "2"):
        outs[amount] = tcli.pc_apply_main(["--device", "cpu", "--extraction_path", ckpt,
                                           "--drift_start", "4", "--drift_end", "2", "--amount",
                                           amount])
    free = tio.read_png_rgb(ckpt[: -len(".npz")] + ".png")
    zero = tio.read_png_rgb(outs["0"][0])
    assert np.abs(zero.astype(int) - free.astype(int)).max() <= 1  # amount 0: drift-free
    assert not np.array_equal(tio.read_png_rgb(outs["2"][0]), zero)


@pytest.mark.parametrize("main,argv", [
    (tcli.sdedit_main, ["--model_id", "test/tiny-sd"]),
    (tcli.pc_extract_main, ["--model_id", "test/tiny-sd"]),
])
def test_image_clis_need_a_card_unless_told_cpu(face, tmp_path, monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv + ["--init_im", face, "--results_path", str(tmp_path)])


def test_pc_apply_cli_needs_a_card_unless_told_cpu(image_extractions, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.pc_apply_main(["--extraction_path", image_extractions["whole"][1],
                            "--drift_start", "4", "--drift_end", "2", "--amount", "1"])
