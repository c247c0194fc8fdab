"""The port's converter at the full geometry of every real checkpoint, its
imports, and its command line.

- Every vendored key manifest (data/key_manifests: ten model ids, made by
  tools/gen_key_manifest.py) is turned into a state dict of zero-stride
  views of its shapes and mapped by ``models/convert.py`` with strict
  accounting onto the full-size port module, built on ``meta``: every
  parameter must be filled, with its shape, and every tensor used or
  dropped by name.
- The converter and the image decoders import, and read a JPEG, the
  Zstandard, LZMA, Group 4 and GZIP_1 FITS inputs, with jax, flax,
  transformers, safetensors, PIL, zstandard and the JAX package blocked.
- ``python -m audioeditingcode_tpu_torch.cli.convert_checkpoint``, then
  ``cli/run.py --device cpu --weights_dir`` on test/tiny-audioldm, gives
  the wav of the same edit from the JAX tool's directory, bit for bit.
  Both edits run with the thread counts fixed (``PINNED_THREADS``): by
  default torch takes one thread per CPU the process may use at its
  start, and the edit's float sums, split by thread, then move a few
  hundred samples of the wav by 1-2 LSB between two runs that start with
  different CPUs free."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from audioeditingcode_tpu_torch.models import convert as cv
from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
from test_torch_helpers import REPO, build_source_checkpoint

MANIFEST_DIR = os.path.join(REPO, "data", "key_manifests")
# manifest file -> the port's part (Stable Audio's vae and projection differ)
_PART = {"unet": "unet", "vae": "vae", "vqvae": "vqvae", "vocoder": "vocoder",
         "language_model": "gpt2", "projection_model": "projection_lm", "transformer": "dit"}
_SA_PART = {"vae": "oobleck", "projection_model": "projection"}


def _manifest(path):
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                key, shape = line.rstrip("\n").split("\t")
                out[key] = tuple(int(s) for s in shape.split(",")) if shape else ()
    return out


def _cases():
    cases = []
    for slug in sorted(os.listdir(MANIFEST_DIR)):
        for f in sorted(os.listdir(os.path.join(MANIFEST_DIR, slug))):
            cases.append((slug.replace("__", "/"), f[: -len(".txt")]))
    return cases


CASES = _cases()


def test_every_manifest_is_covered():
    assert len({m for m, _ in CASES}) == 10 and len(CASES) == 34


@pytest.mark.parametrize("model_id,name", CASES)
def test_manifest_maps_strictly_onto_the_port_module(model_id, name):
    spec = MODEL_SPECS[model_id]
    part = (_SA_PART.get(name, _PART[name]) if spec.family == "stable-audio"
            else _PART[name])
    man = _manifest(os.path.join(MANIFEST_DIR, model_id.replace("/", "__"), name + ".txt"))
    zero = torch.zeros((), dtype=torch.float32)
    sd = {k: zero.expand(shape) for k, shape in man.items()}
    module = cv.convert_part(spec, part, sd, where=name)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in cv.part_factory(spec, part)().state_dict().items()}
    got = module.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert not any(v.is_meta for v in got.values())
    dropped = [k for k in man if any(re.fullmatch(p, k) for p in cv.DROPS.get(part, ()))]
    folded = sum(k.endswith("weight_g") for k in man)
    assert len(want) == len(man) - len(dropped) - folded


_BLOCKER = """
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "transformers", "safetensors", "PIL", "tokenizers",
           "zstandard", "audioeditingcode_tpu", "tools"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
"""


def test_converter_and_image_decoders_import_without_jax_pil_or_transformers():
    code = _BLOCKER + """
import audioeditingcode_tpu_torch.cli.convert_checkpoint as c
import audioeditingcode_tpu_torch.models.convert
import audioeditingcode_tpu_torch.utils.image_ccitt
import audioeditingcode_tpu_torch.utils.image_io as io
import audioeditingcode_tpu_torch.utils.image_zstd
for path, shape in zip(sys.argv[1::2], sys.argv[2::2]):
    img = io.read_image(path)
    assert img.shape == tuple(int(n) for n in shape.split(",")), (path, img.shape)
print("ok", sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED))
"""
    images = os.path.join(REPO, "tests", "data", "images")
    args = []
    for name, shape in (("photo_420_restart.jpg", "384,512,3"),
                        ("photo_zstd_pred2.tif", "384,512,3"), ("photo_lzma.tif", "384,512,3"),
                        ("page_g4.tif", "2200,1728,3"), ("tiles_gzip1.fits", "120,160,3"),
                        ("planar_jpeg_rgba.tif", "192,256,3"),
                        ("jpeg12_grey_strips.tif", "120,160,3"),
                        ("part2_mco_offsets.j2k", "120,160,3")):
        args += [os.path.join(images, name), shape]
    out = subprocess.run([sys.executable, "-c", code] + args, cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok []"


# one fixed split of the CPU edit's sums, whatever the host's load
PINNED_THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2", "OMP_DYNAMIC": "FALSE",
                  "MKL_DYNAMIC": "FALSE"}


def _wav(results):
    wavs = [os.path.join(d, f) for d, _, fs in os.walk(results) for f in fs
            if f.endswith(".wav") and f != "orig.wav"]
    assert len(wavs) == 1, wavs
    from scipy.io import wavfile

    return wavfile.read(wavs[0])


def test_cli_converts_and_the_edit_matches_the_jax_converted_one(tmp_path):
    from test_torch_helpers import write_test_wav
    from tools.convert_checkpoint import convert as jax_convert

    model_id = "test/tiny-audioldm"
    src = build_source_checkpoint(model_id, str(tmp_path / "src"))
    jax_convert(model_id, src, str(tmp_path / "jax"))
    env = dict(os.environ, PYTHONPATH=REPO, **PINNED_THREADS)
    conv = subprocess.run([sys.executable, "-m", "audioeditingcode_tpu_torch.cli.convert_checkpoint",
                           "--model_id", model_id, "--src", src, "--out",
                           str(tmp_path / "port")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert conv.returncode == 0, conv.stderr[-3000:]
    assert "clap_text" in conv.stdout
    clip = write_test_wav(str(tmp_path / "clip.wav"), seconds=0.3)
    wavs = {}
    for name in ("port", "jax"):
        run = subprocess.run(
            [sys.executable, "-m", "audioeditingcode_tpu_torch.cli.run", "--device", "cpu",
             "--model_id", model_id, "--weights_dir", str(tmp_path / name), "--init_aud", clip,
             "--source_prompt", "a sine tone", "--target_prompt", "a trumpet",
             "--num_diffusion_steps", "6", "--tstart", "4", "--seed", "3",
             "--results_path", str(tmp_path / f"results_{name}"), "--wandb_disable"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        wavs[name] = _wav(tmp_path / f"results_{name}")
    (sr_a, a), (sr_b, b) = wavs["port"], wavs["jax"]
    assert sr_a == sr_b and a.shape == b.shape and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, b)
